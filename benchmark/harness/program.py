"""The system under test: the PyTorch port, built from a cell's files.

The configuration file names the program's YAML and overrides, and lists
under ``settings`` every number that the plain reference reads. The mix
may add settings (its batch, its learning rate): those are handed to the
program as overrides. Then every setting is checked against the
program's resolved config, so the two sides cannot run different
models without a refusal.
"""

from __future__ import annotations

from benchmark.harness.spec import CHECKOUT

# the reference's name of a setting -> the program's config key
PROGRAM_KEYS = {
    "backbone": "model.backbone", "num_classes": "model.num_classes",
    "fpn_channels": "model.fpn_channels", "frozen_stages": "model.frozen_stages",
    "dtype": "model.dtype", "canvas": "data.image_size", "short_side": "data.short_side",
    "max_size": "data.max_size",
    "anchor_ratios": "anchors.ratios", "rpn_anchor_scale": "anchors.rpn_scales",
    "pre_nms_topk_test": "rpn.pre_nms_topk_test", "post_nms_topk_test": "rpn.post_nms_topk_test",
    "pre_nms_topk_train": "rpn.pre_nms_topk_train",
    "post_nms_topk_train": "rpn.post_nms_topk_train", "rpn_nms_thresh": "rpn.nms_thresh",
    "rpn_positive_iou": "rpn.positive_iou", "rpn_negative_iou": "rpn.negative_iou",
    "rpn_batch_per_image": "rpn.batch_per_image",
    "rpn_positive_fraction": "rpn.positive_fraction",
    "rpn_smooth_l1_sigma": "rpn.smooth_l1_sigma",
    "roi_batch_per_image": "roi.batch_per_image",
    "roi_positive_fraction": "roi.positive_fraction",
    "roi_positive_iou": "roi.positive_iou", "roi_negative_iou_hi": "roi.negative_iou_hi",
    "roi_negative_iou_lo": "roi.negative_iou_lo", "roi_smooth_l1_sigma": "roi.smooth_l1_sigma",
    "pool_size": "roi.pool_size", "mask_pool_size": "roi.mask_pool_size",
    "sampling_ratio": "roi.sampling_ratio", "bbox_reg_weights": "roi.bbox_reg_weights",
    "mask_resolution": "mask.resolution",
    "score_thresh": "test.score_thresh", "test_nms_thresh": "test.nms_thresh",
    "detections_per_image": "test.detections_per_image", "batch_size": "train.batch_size",
    "base_lr": "train.base_lr", "momentum": "train.momentum",
    "weight_decay": "train.weight_decay", "warmup_steps": "train.warmup_steps",
    "warmup_factor": "train.warmup_factor", "lr_decay_steps": "train.lr_decay_steps",
    "lr_decay_factor": "train.lr_decay_factor", "grad_clip_norm": "train.grad_clip_norm",
    "max_gt_boxes": "train.max_gt_boxes",
}
# the program's defaults that the reference assumes, held like a setting
FIXED = {"model.norm": "frozen_bn", "model.stem": "conv", "model.remat": False,
         "model.name": "mask_rcnn", "model.dilate_c5": False, "rpn.min_size": 0.0,
         "roi.pool_type": "align", "roi.align_impl": "window", "roi.window": -1,
         "roi.window_w": 0, "roi.class_agnostic_regression": False,
         "model.fused_roi_align": "off", "train.loss_scale": 1.0,
         "anchors.rpn_scales": (8.0,)}


def settings(cell) -> dict:
    """The reference's settings of ``cell``: its configuration's, then
    its mix's."""
    return {**cell.config["settings"], **cell.mix.get("settings", {})}


def _lookup(cfg, dotted: str):
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return abs(float(a) - float(b)) <= 1e-12 * max(1.0, abs(float(b)))
    return a == b


def program_config(cell):
    """The program's config for ``cell``; raises if any setting differs."""
    from detectron_tpu_torch.config import get_config

    mix_overrides = [f"{PROGRAM_KEYS[k]}={v}" for k, v in cell.mix.get("settings", {}).items()]
    cfg = get_config(str(CHECKOUT / cell.config["yaml"]),
                     list(cell.config.get("overrides", [])) + mix_overrides)
    wrong = []
    for key, value in settings(cell).items():
        have = _lookup(cfg, PROGRAM_KEYS[key])
        if key == "rpn_anchor_scale":
            have = have[0] if len(have) == 1 else have
        if not _same(have, value):
            wrong.append(f"{PROGRAM_KEYS[key]}: program {have!r}, reference {value!r}")
    for key, value in FIXED.items():
        if not _same(_lookup(cfg, key), value):
            wrong.append(f"{key}: program {_lookup(cfg, key)!r}, reference {value!r}")
    if wrong:
        raise ValueError("the program's config differs from the reference's settings:\n  "
                         + "\n  ".join(wrong))
    return cfg


def build_detector(cfg, device):
    """The program's detector on ``device``."""
    from detectron_tpu_torch.models.zoo import build_detector as build

    return build(cfg, device=device)


def parameter_shapes(det) -> dict:
    """``{name: shape}`` of the program's state dict."""
    return {k: tuple(v.shape) for k, v in det.module.state_dict().items()}
