"""R-FCN: the region-based fully convolutional detector, its eval and train
passes.

The port of ``detectron_tpu/models/rfcn.py``: a ResNet backbone whose C4
(stride 16), or with ``model.dilate_c5`` its a-trous C5 (also stride 16),
feeds a ReLU 3x3 trunk conv of ``model.fpn_channels`` channels; one RPN
level on the trunk (``len(anchors.ratios) * len(anchors.rfcn_scales)``
anchors a cell); two 1x1 convs give the position-sensitive maps
(``P*P*K`` class channels, ``P*P*4`` class-agnostic box channels), cast to
float32 whatever the compute dtype; one PSRoIPool over the two maps
merged group by group (``[B, H, W, P*P*(K+4)]``: pooling is per channel,
so this equals two pools); the vote is the mean over the ``P x P`` bins.
Eval and training reuse Faster R-CNN's proposals, RoI sampling, losses
and detection post-process (``models/faster_rcnn.py``), with the
class-agnostic regression ``[B, R, 1, 4]``. Kernel K1 runs the NMS of the
proposals and of the detections; no RoIAlign kernel runs.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.layers.proposal_target import sample_rois
from detectron_tpu_torch.models import faster_rcnn as frcnn
from detectron_tpu_torch.models.heads import RPNHead
from detectron_tpu_torch.models.precision import Conv2d, compute_dtype
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.ops.anchors import AnchorGenerator
from detectron_tpu_torch.ops.boxes import true_div
from detectron_tpu_torch.ops.ps_roi_pool import ps_roi_pool

RFCN_STRIDE = 16  # the trunk's stride: C4, or the a-trous C5


def rfcn_anchor_generator(cfg) -> AnchorGenerator:
    """Single-level RPN anchors: ``anchors.rfcn_scales`` x ratios at stride
    16 (128/256/512-pixel boxes at the default (8, 16, 32))."""
    scales = tuple(cfg.anchors.rfcn_scales)
    return AnchorGenerator(
        strides=(RFCN_STRIDE,),
        ratios=cfg.anchors.ratios,
        octave_scales=tuple(s / scales[0] for s in scales),
        base_scale=scales[0],
    )


class RFCN(nn.Module):
    """Backbone + trunk + RPN + position-sensitive maps, with the JAX
    module's methods: ``features`` (NHWC float32 images -> the trunk's
    output, NCHW in the module's memory format and compute dtype), ``rpn``
    (one level's objectness and deltas) and ``box`` (class logits
    ``[B, R, K]`` and class-agnostic deltas ``[B, R, 1, 4]``, float32).
    ``forward`` is the eval pass (:func:`rfcn_eval_forward`) or, given
    targets and draws, the training pass's loss dict
    (:func:`rfcn_train_forward`).

    The parameters stay float32 and every conv computes in ``dtype``
    (``model.dtype``); the boxes that K1 sees are float32. On the C4 trunk
    the backbone's res5 is built (the JAX module has its parameters, so
    weights carry across) but never run."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg.model.dtype)
        self.dilate_c5 = cfg.model.dilate_c5
        self.num_classes = cfg.model.num_classes  # background included
        self.pool = cfg.roi.pool_size
        ch = cfg.model.fpn_channels
        self.backbone = ResNet(
            depth=cfg.model.backbone, frozen_stages=cfg.model.frozen_stages,
            norm=cfg.model.norm, stem=cfg.model.stem, dilate_c5=self.dilate_c5,
            remat=cfg.model.remat, dtype=dt)
        cin = self.backbone.out_channels[3 if self.dilate_c5 else 2]
        self.trunk = Conv2d(cin, ch, 3, padding=1, compute_dtype=dt)
        self.rpn_head = RPNHead(ch, len(cfg.anchors.ratios) * len(cfg.anchors.rfcn_scales),
                                dtype=dt)
        p2 = self.pool * self.pool
        self.ps_cls = Conv2d(ch, p2 * self.num_classes, 1, compute_dtype=dt)
        self.ps_box = Conv2d(ch, p2 * 4, 1, compute_dtype=dt)
        self.set_channels_last(frcnn.CHANNELS_LAST[dt])
        self._anchors = {}

    set_channels_last = frcnn.TwoStageDetector.set_channels_last

    def anchors(self, image_shape, device) -> list[torch.Tensor]:
        """The RPN's anchors of a padded canvas (one level), made once per
        shape."""
        key = (tuple(image_shape), str(device))
        if key not in self._anchors:
            gen = rfcn_anchor_generator(self.cfg)
            self._anchors[key] = [torch.as_tensor(a, device=device)
                                  for a in gen.grid_anchors(tuple(image_shape))]
        return self._anchors[key]

    def features(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=self.memory_format)
        if self.dilate_c5:
            x = self.backbone(x)["c5"]
        else:  # res5 is not run
            x = self.backbone(x, stages=3)["c4"]
        return F.relu(self.trunk(x))

    def rpn(self, feat):
        scores, deltas = self.rpn_head(feat)
        return [scores], [deltas]

    def ps_maps(self, feat):
        """The two position-sensitive maps as one float32 NHWC table
        ``[B, H, W, P*P*(K+4)]``, group-major: each of the ``P*P`` groups'
        ``K`` class channels, then its 4 box channels."""
        b, _, h, w = feat.shape
        p2, k = self.pool * self.pool, self.num_classes
        cls_map = self.ps_cls(feat).float().permute(0, 2, 3, 1).reshape(b, h, w, p2, k)
        box_map = self.ps_box(feat).float().permute(0, 2, 3, 1).reshape(b, h, w, p2, 4)
        return torch.cat([cls_map, box_map], dim=-1).reshape(b, h, w, p2 * (k + 4))

    def vote(self, table, rois):
        """PSRoIPool of ``table`` (:meth:`ps_maps`) on ``rois``, then the mean
        over the ``P x P`` bins: ``(class logits [B, R, K], deltas
        [B, R, 1, 4])``."""
        k = self.num_classes
        pooled = ps_roi_pool(table, rois.contiguous(), RFCN_STRIDE, output_size=self.pool,
                             sampling_ratio=self.cfg.roi.sampling_ratio)  # [B, R, P, P, K+4]
        votes = true_div(pooled.sum(dim=(2, 3)), self.pool * self.pool)
        return votes[..., :k], votes[..., None, k:]

    def box(self, feat, rois):
        return self.vote(self.ps_maps(feat), rois)

    def forward(self, images, image_hw, targets=None, draws=None, mark=None):
        """The eval pass's :class:`faster_rcnn.Detections`, or with
        ``targets`` (``gt_boxes``, ``gt_classes``) and ``draws`` the training
        pass's loss dict."""
        if targets is not None:
            return rfcn_train_forward(self, images, image_hw, targets["gt_boxes"],
                                      targets["gt_classes"], draws, self.cfg, mark=mark)
        return rfcn_eval_forward(self, images, image_hw, self.cfg)


def rfcn_train_forward(model: RFCN, images, image_hw, gt_boxes, gt_classes, draws, cfg,
                       mark=None):
    """One training forward: the RPN losses and the box losses of the
    voted logits on the sampled RoIs. ``draws``: a
    :class:`faster_rcnn.TrainDraws` sized to the one RPN level's anchors, or
    a ``torch.Generator`` to make one from. ``mark``: as in
    :func:`faster_rcnn.faster_rcnn_train_forward`."""
    mark = mark or frcnn._no_mark
    anchors_pl = model.anchors(images.shape[1:3], images.device)
    if isinstance(draws, torch.Generator):
        draws = frcnn.make_train_draws(
            draws, images.shape[0], anchors_pl[0].shape[0],
            cfg.rpn.post_nms_topk_train + gt_boxes.shape[1])
    mark("anchors+draws")
    feat = model.features(images)
    mark("backbone+trunk")
    scores_pl, deltas_pl = model.rpn(feat)
    mark("rpn head")
    loss_dict = frcnn.rpn_losses(scores_pl, deltas_pl, anchors_pl[0], gt_boxes, gt_classes,
                                 draws, cfg)
    mark("rpn targets+loss")
    props = frcnn.proposals_from_rpn([s.detach() for s in scores_pl],
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
    table = model.ps_maps(feat)
    mark("ps maps")
    cls_logits, reg = model.vote(table, tgt.rois)
    loss_dict.update(frcnn.frcnn_box_losses(cls_logits, reg, tgt, cfg))
    mark("psroipool + vote + loss")
    return loss_dict


def rfcn_eval_forward(model: RFCN, images, image_hw, cfg) -> frcnn.Detections:
    """One eval pass: padded :class:`faster_rcnn.Detections`. ``images`` are
    NHWC ``[B, H, W, 3]``, ``image_hw`` ``[B, 2]``."""
    anchors_pl = model.anchors(images.shape[1:3], images.device)
    feat = model.features(images)
    scores_pl, deltas_pl = model.rpn(feat)
    props = frcnn.proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, image_hw, cfg)
    cls_logits, reg = model.box(feat, props.boxes)
    return frcnn.fastrcnn_inference(cls_logits, reg, props.boxes, props.valid, image_hw, cfg)
