"""Default configuration of the PyTorch port.

Every key of the JAX package's defaults (``detectron_tpu/config/defaults.py``)
with the same value, so a YAML file or a ``key=value`` override means the
same thing to both packages. Keys that only choose a TPU schedule
(``model.fused_nms``, ``model.fused_roi_align``, ``model.nms_algo``,
``roi.chunk``, ``roi.align_x8``, ``roi.bwd_order``, ``rpn.topk_recall``,
``rpn.exact_topk``, ``retinanet.topk_recall``) are accepted and ignored:
every schedule computes the same function, and the port has one.
``roi.window`` / ``roi.window_w`` are read, because they set the RoIAlign
routing span (``ops.roi_align.roi_max_span``).
"""

from __future__ import annotations

from detectron_tpu_torch.config.attrdict import AttrDict


def base_config() -> AttrDict:
    cfg = AttrDict()

    cfg.model = AttrDict()
    cfg.model.name = "faster_rcnn"  # faster_rcnn | mask_rcnn | retinanet | rfcn
    cfg.model.backbone = "resnet50"  # resnet50 | resnet101 | resnext101_64x4d (the port alone)
    cfg.model.stem = "conv"  # s2d is an exact re-layout of the same conv
    cfg.model.num_classes = 81  # includes background at index 0
    cfg.model.fpn_channels = 256
    cfg.model.frozen_stages = 1
    cfg.model.norm = "frozen_bn"  # frozen_bn | gn
    cfg.model.dilate_c5 = False
    cfg.model.remat = False
    cfg.model.weights = ""
    cfg.model.dtype = "float32"  # float32 | bfloat16
    cfg.model.fused_nms = "off"
    cfg.model.fused_roi_align = "off"
    cfg.model.nms_algo = "auto"

    cfg.anchors = AttrDict()
    cfg.anchors.ratios = (0.5, 1.0, 2.0)
    cfg.anchors.rpn_scales = (8.0,)
    cfg.anchors.rfcn_scales = (8.0, 16.0, 32.0)
    cfg.anchors.retinanet_scales = (1.0, 1.2599210498948732, 1.5874010519681994)
    cfg.anchors.retinanet_base_scale = 4.0

    cfg.rpn = AttrDict()
    cfg.rpn.pre_nms_topk_train = 2000  # per level
    cfg.rpn.pre_nms_topk_test = 1000
    cfg.rpn.post_nms_topk_train = 1000  # across levels
    cfg.rpn.post_nms_topk_test = 300
    cfg.rpn.nms_thresh = 0.7
    cfg.rpn.min_size = 0.0
    cfg.rpn.exact_topk = False
    cfg.rpn.topk_recall = 0.99
    cfg.rpn.positive_iou = 0.7
    cfg.rpn.negative_iou = 0.3
    cfg.rpn.batch_per_image = 256
    cfg.rpn.positive_fraction = 0.5
    cfg.rpn.smooth_l1_sigma = 3.0

    cfg.roi = AttrDict()
    cfg.roi.batch_per_image = 512
    cfg.roi.positive_fraction = 0.25
    cfg.roi.positive_iou = 0.5
    cfg.roi.negative_iou_hi = 0.5
    cfg.roi.negative_iou_lo = 0.0
    cfg.roi.pool_size = 7
    cfg.roi.mask_pool_size = 14
    cfg.roi.sampling_ratio = 2
    cfg.roi.pool_type = "align"  # align | pool
    cfg.roi.align_impl = "window"  # window | gather: sets the routing span
    cfg.roi.window = -1
    cfg.roi.window_w = 0
    cfg.roi.chunk = -1
    cfg.roi.bwd_order = "sep"
    cfg.roi.align_x8 = False
    cfg.roi.bbox_reg_weights = (10.0, 10.0, 5.0, 5.0)
    cfg.roi.smooth_l1_sigma = 1.0
    cfg.roi.class_agnostic_regression = False

    cfg.retinanet = AttrDict()
    cfg.retinanet.positive_iou = 0.5
    cfg.retinanet.negative_iou = 0.4
    cfg.retinanet.focal_alpha = 0.25
    cfg.retinanet.focal_gamma = 2.0
    cfg.retinanet.prior_prob = 0.01
    cfg.retinanet.pre_nms_topk = 1000
    cfg.retinanet.exact_topk = False
    cfg.retinanet.topk_recall = 0.99
    cfg.retinanet.merged_pre_nms_topk = 0
    cfg.retinanet.score_thresh = 0.05
    cfg.retinanet.nms_thresh = 0.5
    cfg.retinanet.smooth_l1_beta = 0.1111111111111111  # = 1/9

    cfg.mask = AttrDict()
    cfg.mask.resolution = 28
    cfg.mask.paste_threshold = 0.5

    cfg.test = AttrDict()
    cfg.test.score_thresh = 0.05
    cfg.test.nms_thresh = 0.5
    cfg.test.detections_per_image = 100
    cfg.test.bbox_reg_stds_applied = True

    cfg.train = AttrDict()
    cfg.train.batch_size = 8
    cfg.train.base_lr = 0.01
    cfg.train.momentum = 0.9
    cfg.train.weight_decay = 1e-4
    cfg.train.warmup_steps = 500
    cfg.train.warmup_factor = 1.0 / 3.0
    cfg.train.lr_decay_steps = (60000, 80000)
    cfg.train.lr_decay_factor = 0.1
    cfg.train.max_steps = 90000
    cfg.train.grad_clip_norm = 0.0
    cfg.train.checkpoint_every = 5000
    cfg.train.log_every = 20
    cfg.train.seed = 0
    cfg.train.max_gt_boxes = 100
    cfg.train.loss_scale = 1.0
    cfg.train.debug_nans = False

    cfg.data = AttrDict()
    cfg.data.dataset = "coco"  # coco | voc | citypersons | synthetic
    cfg.data.voc_use_07_metric = False
    cfg.data.root = ""
    cfg.data.train_split = "train2017"
    cfg.data.val_split = "val2017"
    cfg.data.short_side = 800
    cfg.data.train_scales = ()
    cfg.data.max_size = 1333
    cfg.data.pad_stride = 128
    cfg.data.hflip_prob = 0.5
    cfg.data.pixel_mean = (123.675, 116.28, 103.53)
    cfg.data.pixel_std = (58.395, 57.12, 57.375)
    cfg.data.num_workers = 8
    cfg.data.image_size = (1024, 1024)  # padded canvas (H, W)
    cfg.data.orientation_buckets = False

    cfg.parallel = AttrDict()
    cfg.parallel.data_axis = "data"
    cfg.parallel.num_devices = 0
    cfg.parallel.coordinator_address = ""
    cfg.parallel.num_processes = 0
    cfg.parallel.process_id = -1

    cfg.output_dir = "/tmp/detectron_tpu"
    return cfg
