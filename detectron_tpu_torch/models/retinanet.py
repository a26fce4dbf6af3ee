"""RetinaNet: the dense one-stage detector, its eval and train passes.

The port of ``detectron_tpu/models/retinanet.py``: a ResNet backbone, the
P3-P7 FPN, and one head shared by the five levels (four 3x3 ReLU convs
each for the class and the box subnet, ``A*K`` class logits with the
prior bias ``-log((1-pi)/pi)``, ``A*4`` deltas). Training: focal loss and
smooth-L1 (beta) over every anchor, targets from ``anchor_target`` with
forced matches and no sampling. Inference: per image and level the top
``retinanet.pre_nms_topk`` of the flat logits, decoded against their
anchors and clipped; the levels merged (optionally capped to the top
``retinanet.merged_pre_nms_topk``), thresholded in logit space, and one
class-aware NMS over all of them, which is one launch of kernel K1 for
the batch on the card.

The top-k's are exact and order ties at the lower index first, as
``jax.lax.top_k`` does; ``retinanet.exact_topk`` and ``topk_recall`` only
choose a TPU schedule in the JAX package and change nothing here. Head
outputs leave the module NHWC (``[B, H, W, A*K]``), so flattening them
gives the anchors' (y, x, anchor, class) order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.layers.anchor_target import anchor_target
from detectron_tpu_torch.layers.proposal import topk_desc
from detectron_tpu_torch.models import losses
from detectron_tpu_torch.models.faster_rcnn import CHANNELS_LAST, Detections
from detectron_tpu_torch.models.fpn import FPN
from detectron_tpu_torch.models.precision import Conv2d, compute_dtype
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.ops import boxes as box_ops
from detectron_tpu_torch.ops.anchors import AnchorGenerator
from detectron_tpu_torch.ops.nms import class_aware_nms
from detectron_tpu_torch.parallel.mesh import global_sum
from detectron_tpu_torch.utils.spans import span

RETINA_STRIDES = (8, 16, 32, 64, 128)  # P3..P7


def prior_bias(prior_prob: float) -> float:
    """The class logits' initial bias: every anchor starts at ``prior_prob``."""
    return -math.log((1.0 - prior_prob) / prior_prob)


class RetinaNetHead(nn.Module):
    """The class and box subnets, shared by every level: NCHW ``x`` ->
    ``(class logits [B, H, W, A*K], deltas [B, H, W, A*4])``."""

    def __init__(self, num_classes: int, num_anchors: int = 9, channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"cls{i}", Conv2d(channels, channels, 3, padding=1,
                                              compute_dtype=dtype))
            self.add_module(f"box{i}", Conv2d(channels, channels, 3, padding=1,
                                              compute_dtype=dtype))
        self.cls_score = Conv2d(channels, num_anchors * num_classes, 3, padding=1,
                                compute_dtype=dtype)
        self.box_pred = Conv2d(channels, num_anchors * 4, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        cls, box = x, x
        for i in range(4):
            cls = F.relu(getattr(self, f"cls{i}")(cls))
            box = F.relu(getattr(self, f"box{i}")(box))
        return (self.cls_score(cls).permute(0, 2, 3, 1),
                self.box_pred(box).permute(0, 2, 3, 1))


def retinanet_anchor_generator(cfg) -> AnchorGenerator:
    return AnchorGenerator(
        strides=RETINA_STRIDES,
        ratios=cfg.anchors.ratios,
        octave_scales=cfg.anchors.retinanet_scales,
        base_scale=cfg.anchors.retinanet_base_scale,
    )


class RetinaNet(nn.Module):
    """Backbone + P3-P7 FPN + shared head, with ``features`` (backbone and
    FPN: NCHW levels in the module's memory format and compute dtype) and
    ``head_outputs`` (per level ``(class logits, deltas)``, NHWC).
    ``forward`` is the eval pass (:func:`retinanet_eval_forward`) or, given
    targets, the training pass's loss dict
    (:func:`retinanet_train_forward`).

    ``dtype`` (``model.dtype``) is the compute dtype of every layer; the
    parameters stay float32. Decode promotes the deltas against the
    float32 anchors, so the boxes K1 sees are float32 whatever the dtype;
    logits and scores come in ``dtype``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg.model.dtype)
        self.num_classes = cfg.model.num_classes - 1  # foreground classes
        ch = cfg.model.fpn_channels
        self.backbone = ResNet(
            depth=cfg.model.backbone, frozen_stages=cfg.model.frozen_stages,
            norm=cfg.model.norm, stem=cfg.model.stem, remat=cfg.model.remat, dtype=dt)
        self.fpn = FPN(self.backbone.out_channels, ch, levels="p3p7", dtype=dt)
        num_anchors = len(cfg.anchors.ratios) * len(cfg.anchors.retinanet_scales)
        self.head = RetinaNetHead(self.num_classes, num_anchors, ch, dtype=dt)
        self.set_channels_last(CHANNELS_LAST[dt])
        self._anchors = {}

    def set_channels_last(self, on: bool) -> None:
        """Runs the convolutions channels-last (NHWC in memory) or NCHW; with
        channels-last the head's NHWC outputs are views, without a copy."""
        self.memory_format = torch.channels_last if on else torch.contiguous_format
        for m in self.modules():
            if m is not self and hasattr(m, "memory_format"):
                m.memory_format = self.memory_format

    def anchors(self, image_shape, device) -> list[torch.Tensor]:
        """Per-level anchors ``[Hl*Wl*A, 4]`` of a padded canvas, made once
        per shape."""
        key = (tuple(image_shape), str(device))
        if key not in self._anchors:
            gen = retinanet_anchor_generator(self.cfg)
            self._anchors[key] = [torch.as_tensor(a, device=device)
                                  for a in gen.grid_anchors(tuple(image_shape))]
        return self._anchors[key]

    def features(self, images):
        """NHWC images ``[B, H, W, 3]`` (float32) -> levels P3..P7."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=self.memory_format)
        return self.fpn(self.backbone(x))

    def head_outputs(self, levels):
        return [self.head(p) for p in levels]

    def forward(self, images, image_hw, targets=None, mark=None):
        """The eval pass, or with ``targets`` (``gt_boxes``, ``gt_classes``)
        the training pass's loss dict."""
        if targets is not None:
            return retinanet_train_forward(self, images, targets["gt_boxes"],
                                           targets["gt_classes"], self.cfg, mark=mark)
        return retinanet_eval_forward(self, images, image_hw, self.cfg)


def flatten_outputs(outputs, num_classes: int):
    """Per-level ``[(cls [B, H, W, A*K], box [B, H, W, A*4])]`` ->
    ``(cls [B, N, K], box [B, N, 4])``, N anchors in (level, y, x, anchor)
    order."""
    b = outputs[0][0].shape[0]
    cls = torch.cat([c.reshape(b, -1, num_classes) for c, _ in outputs], 1)
    box = torch.cat([d.reshape(b, -1, 4) for _, d in outputs], 1)
    return cls, box


def retinanet_loss(outputs, anchors, gt_boxes, gt_classes, cfg) -> dict:
    """Focal loss over every anchor and class, smooth-L1 (beta) over the
    positives, both divided by the batch's positive count (at least 1;
    the global batch's under a data-parallel group, ``global_sum``).
    ``anchors``: ``[N, 4]``, all levels."""
    k = cfg.model.num_classes - 1
    rc = cfg.retinanet
    cls_logits, box_deltas = flatten_outputs(outputs, k)
    tgt = anchor_target(anchors, gt_boxes, gt_classes, None, None,
                        pos_iou=rc.positive_iou, neg_iou=rc.negative_iou,
                        force_match=True, sample_size=0)
    # one-hot of labels - 1 over the k foreground classes: background (0) and
    # ignored (-1) anchors are all zeros (a comparison: F.one_hot checks its
    # input's range on the host)
    classes = torch.arange(1, k + 1, dtype=tgt.labels.dtype, device=tgt.labels.device)
    onehot = (tgt.labels[..., None] == classes).to(cls_logits.dtype)
    total_pos = global_sum(tgt.num_pos.sum()).clamp_min(1.0)
    cls_loss = losses.sigmoid_focal_loss(cls_logits, onehot, alpha=rc.focal_alpha,
                                         gamma=rc.focal_gamma, weights=tgt.cls_weights,
                                         normalizer=total_pos)
    box_l = losses.smooth_l1_beta(box_deltas, tgt.box_targets, rc.smooth_l1_beta)
    box_loss = (box_l.sum(-1) * tgt.box_weights).sum() / total_pos.clamp_min(1.0)
    return {"loss_cls": cls_loss, "loss_box": box_loss}


def retinanet_train_forward(model: RetinaNet, images, gt_boxes, gt_classes, cfg,
                            mark=None) -> dict:
    """One training forward: the loss dict. Each stage is a span
    (``utils/spans.py``); ``mark``, if given, is called with each stage's
    name once the stage's work has been issued."""
    with span("backbone+fpn", mark):
        anchors = torch.cat(model.anchors(images.shape[1:3], images.device), 0)
        levels = model.features(images)
    with span("head", mark):
        outputs = model.head_outputs(levels)
    with span("anchor targets+loss", mark):
        loss_dict = retinanet_loss(outputs, anchors, gt_boxes, gt_classes, cfg)
    return loss_dict


def retinanet_candidates(outputs, anchors_pl, image_hw, cfg):
    """The candidates that enter the merged NMS: per level the top
    ``pre_nms_topk`` logits of each image's ``[Nl*K]`` table, their boxes
    decoded against float32 anchors and clipped to ``image_hw``, the levels
    concatenated and, with ``merged_pre_nms_topk``, cut to the top that
    many logits. Returns ``(boxes [B, T, 4] float32, logits [B, T],
    classes [B, T] 1-based int64)``."""
    k = cfg.model.num_classes - 1
    b = image_hw.shape[0]
    hgt, wid = image_hw[:, 0, None], image_hw[:, 1, None]
    cand_boxes, cand_logits, cand_cls = [], [], []
    for (cls_l, box_l), anc in zip(outputs, anchors_pl):
        flat = cls_l.reshape(b, -1)  # [B, Nl*K], (y, x, anchor, class) order
        t = min(cfg.retinanet.pre_nms_topk, flat.shape[1])
        top_logits, top_idx = topk_desc(flat, t)
        a_idx = torch.div(top_idx, k, rounding_mode="floor")
        deltas = torch.gather(box_l.reshape(b, -1, 4), 1, a_idx[..., None].expand(b, t, 4))
        boxes = box_ops.clip_boxes(box_ops.decode_boxes(deltas, anc[a_idx]), hgt, wid)
        cand_boxes.append(boxes)
        cand_logits.append(top_logits)
        cand_cls.append(top_idx % k + 1)
    boxes = torch.cat(cand_boxes, 1)
    logits = torch.cat(cand_logits, 1)
    classes = torch.cat(cand_cls, 1)
    cap = int(cfg.retinanet.merged_pre_nms_topk)
    if cap and cap < logits.shape[1]:
        logits, sel = topk_desc(logits, cap)
        boxes = torch.gather(boxes, 1, sel[..., None].expand(b, cap, 4))
        classes = torch.gather(classes, 1, sel)
    return boxes, logits, classes


def retinanet_detections(boxes, logits, classes, cfg) -> Detections:
    """Sigmoid scores, the score threshold (in logit space, compared in the
    logits' dtype as the JAX package compares), class-aware NMS to
    ``test.detections_per_image`` padded slots."""
    t = cfg.retinanet.score_thresh
    logit_thresh = float(np.log(t / (1.0 - t)))
    scores = torch.sigmoid(logits)
    valid = logits > logit_thresh
    d = cfg.test.detections_per_image
    idx, keep = class_aware_nms(boxes, scores, classes, cfg.retinanet.nms_thresh, d,
                                valid=valid)
    idx = idx.long()
    kept_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, d, 4))
    return Detections(
        boxes=torch.where(keep[..., None], kept_boxes, torch.zeros_like(kept_boxes)),
        scores=torch.where(keep, torch.gather(scores, 1, idx), torch.zeros_like(keep,
                                                                         dtype=scores.dtype)),
        classes=torch.where(keep, torch.gather(classes, 1, idx),
                            torch.zeros_like(idx)).to(torch.int32),
        valid=keep,
    )


def retinanet_inference(outputs, anchors_pl, image_hw, cfg) -> Detections:
    """The whole post-process: :func:`retinanet_candidates`, then
    :func:`retinanet_detections`."""
    return retinanet_detections(*retinanet_candidates(outputs, anchors_pl, image_hw, cfg),
                                cfg)


def retinanet_eval_forward(model: RetinaNet, images, image_hw, cfg) -> Detections:
    """One eval pass: NHWC ``images [B, H, W, 3]``, ``image_hw [B, 2]`` ->
    padded :class:`Detections`."""
    anchors_pl = model.anchors(images.shape[1:3], images.device)
    outputs = model.head_outputs(model.features(images))
    return retinanet_inference(outputs, anchors_pl, image_hw, cfg)
