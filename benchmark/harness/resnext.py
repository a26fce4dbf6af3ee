"""What a ResNeXt cell adds to the harness: its model FLOPs, the bound of
its grouped convolutions, and its weights calibrated by its own
reference (``reference/resnext.py``).

FLOPs are ``harness/flops.py``'s count with the trunk's widths: a
convolution of ``g`` groups does ``2 * (cin / g) * cout * k * k * h * w``.

A grouped 3x3's bound is the larger of its FLOPs over the bf16 dense peak
and its bytes over the memory rate: its input, weight and output each
read or written once, 2 bytes a value (bf16), whatever implements it.
"""

from __future__ import annotations

import torch

from benchmark.harness import flops, roofline, weights
from benchmark.harness.flops import Layer, conv_flops, conv_out
from benchmark.reference import model as plain
from benchmark.reference import resnext as ref


def backbone_layers(name: str, hw, frozen_stages: int = 1) -> tuple[list, list]:
    """The trunk's layers at input ``hw`` and the (channels, h, w) of C2-C5
    (``flops.backbone_layers`` with grouped 3x3s)."""
    stage_blocks, groups, width = ref.TRUNKS[name]
    h, w = hw
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    layers = [Layer("stem", conv_flops(3, 64, 7, h, w), trains=False)]
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin, outs = 64, []
    for stage, blocks in enumerate(stage_blocks):
        inner, cout = groups * width * 2 ** stage, 256 * 2 ** stage
        frozen = stage + 1 <= frozen_stages
        after_frozen = stage == frozen_stages
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h2, w2 = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            first = after_frozen and i == 0
            tag = f"layer{stage + 1}.{i}"
            layers += [
                Layer(tag + ".conv1", conv_flops(cin, inner, 1, h, w), not frozen, not first),
                Layer(tag + ".conv2", conv_flops(inner // groups, inner, 3, h2, w2), not frozen),
                Layer(tag + ".conv3", conv_flops(inner, cout, 1, h2, w2), not frozen)]
            if i == 0:
                layers.append(Layer(tag + ".downsample", conv_flops(cin, cout, 1, h2, w2),
                                    not frozen, not first))
            h, w, cin = h2, w2, cout
        outs.append((cin, h, w))
    return layers, outs


def model_layers(s: dict, train: bool, canvas=None) -> list:
    """``flops.model_layers`` over this trunk."""
    canvas = canvas or s["canvas"]
    frozen = s["frozen_stages"]
    layers, outs = backbone_layers(s["backbone"], canvas, frozen)
    layers += flops.fpn_rpn_layers(outs, s["fpn_channels"], len(s["anchor_ratios"]), frozen)
    if train:
        rois = s["roi_batch_per_image"]
        masks = max(int(s["roi_batch_per_image"] * s["roi_positive_fraction"]), 1)
    else:
        rois, masks = s["post_nms_topk_test"], s["detections_per_image"]
    layers += flops.box_head_layers(rois, s["fpn_channels"], s["pool_size"], s["num_classes"])
    layers += flops.mask_head_layers(masks, s["fpn_channels"], s["mask_pool_size"],
                                     s["num_classes"])
    return layers


def image_flops(s: dict, train: bool, canvas=None) -> float:
    """FLOPs of one image's inference, or of its share of a training step."""
    return sum(x.train_flops() if train else x.flops for x in model_layers(s, train, canvas))


def grouped_convs(name: str, hw) -> list[tuple]:
    """The trunk's grouped 3x3s at input ``hw``, in order: ``(channels,
    groups, h_in, w_in, h_out, w_out)`` (channels in = out)."""
    stage_blocks, groups, width = ref.TRUNKS[name]
    if groups == 1:
        return []
    h, w = hw
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    convs = []
    for stage, blocks in enumerate(stage_blocks):
        inner = groups * width * 2 ** stage
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h2, w2 = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            convs.append((inner, groups, h, w, h2, w2))
            h, w = h2, w2
    return convs


def grouped_conv_bound_s(name: str, hw, batch: int, elem: int = 2) -> float:
    """The summed bounds of the trunk's grouped 3x3s on a batch of
    ``batch`` images at ``hw``, ``elem`` bytes a value."""
    total = 0.0
    for c, g, h, w, h2, w2 in grouped_convs(name, hw):
        ops = batch * conv_flops(c // g, c, 3, h2, w2)
        nbytes = elem * (batch * c * h * w + c * (c // g) * 9 + batch * c * h2 * w2)
        total += max(ops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_HBM_BYTES)
    return total


@torch.no_grad()
def calibrate_logits(params: dict, mcfg: dict, images, image_hw, logits: dict) -> None:
    """``harness/weights.py::calibrate_logits`` over this trunk: the RPN
    objectness, class-score, box-delta and mask-logit weights scaled to the
    spreads ``logits`` names, and the class biases set. In place."""
    net = ref.Net(params, mcfg)
    levels = net.features(images)
    scores, deltas = net.rpn(levels)
    obj = torch.cat(scores, 1)
    w = params["rpn_head.objectness.weight"]
    w.mul_(logits["objectness_std"] / obj.std().clamp_min(1e-12))
    scores, deltas = net.rpn(levels)
    props, valid = plain.eval_proposals(mcfg, scores, deltas, image_hw, images.shape[1:3])
    cls_logits, reg = net.box(levels, props)
    spread = cls_logits[valid][:, 1:].std().clamp_min(1e-12)
    params["box_head.cls_score.weight"].mul_(logits["class_std"] / spread)
    spread = reg[valid][:, 1:].std().clamp_min(1e-12)
    params["box_head.bbox_pred.weight"].mul_(logits["box_delta_std"] / spread)
    bias = params["box_head.cls_score.bias"]
    bias.fill_(logits["class_bias"])
    bias[0] = logits["background_bias"]
    cls_logits, reg = net.box(levels, props)
    dets = plain.detect(cls_logits, reg, props, valid, image_hw, mcfg)
    own = plain.own_class_probs(net.mask(levels, dets.boxes), dets.classes)
    spread = torch.logit(own[dets.valid].clamp(1e-6, 1 - 1e-6)).std().clamp_min(1e-12)
    params["mask_head.mask_logits.weight"].mul_(logits["mask_std"] / spread)


def make_params(run, shapes: dict, calib: dict) -> dict:
    """``harness/common.py::make_params`` over this trunk: weights drawn
    from the seed (``weights.random_params``: a grouped weight ``[cout,
    cin / g, 3, 3]`` takes He fan-out over ``cout * 9``, as the program's
    init), frozen statistics and logits set by this trunk's reference."""
    params = weights.random_params(shapes, run.seed, run.device,
                                   run.cell.config.get("residual_gamma", 1.0))
    ref.calibrate_frozen_bn(params, run.settings, calib["image"])
    if "logits" in run.cell.config:
        calibrate_logits(params, run.settings, calib["image"], calib["image_hw"],
                         run.cell.config["logits"])
    return params
