"""Model FLOPs of Mask R-CNN ResNet-FPN, counted from the configuration's
layer shapes: convolutions and matrix products only (2 a multiply-add),
whatever implements them.

Inference counts the backbone and FPN at the canvas, the RPN head on
P2-P6, the box head on every proposal slot and the mask head on every
detection slot. Training counts the forward on the step's shapes (the box
head on the sampled RoIs, the mask head on the foreground slots) and the
backward that the trainable weights and the gradients of their inputs
need, with no recompute: a layer's weight gradient costs its forward
again, its input gradient once more where the input takes a gradient.
The stem and the frozen stages run forward only.
"""

from __future__ import annotations

from benchmark.reference.model import STAGE_BLOCKS


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * cin * cout * k * k * hout * wout


class Layer:
    """One convolution or matrix product: forward FLOPs, and whether its
    weight trains and its input takes a gradient."""

    def __init__(self, name, flops, trains=True, input_grad=True):
        self.name, self.flops, self.trains, self.input_grad = name, flops, trains, input_grad

    def train_flops(self) -> float:
        backward = (self.flops if self.trains else 0.0) + (
            self.flops if self.trains and self.input_grad else 0.0)
        return self.flops + backward


def backbone_layers(depth: str, hw, frozen_stages: int = 1) -> tuple[list, list]:
    """The ResNet's layers at input ``hw`` and the (channels, h, w) of C2-C5."""
    h, w = hw
    layers = []
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    layers.append(Layer("stem", conv_flops(3, 64, 7, h, w), trains=False))
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin, feats, outs = 64, 64, []
    for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
        frozen = stage + 1 <= frozen_stages
        after_frozen = stage == frozen_stages  # its first block reads a detached input
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h2, w2 = conv_out(h, 3, stride, 1), conv_out(w, 3, stride, 1)
            first = after_frozen and i == 0
            tag = f"layer{stage + 1}.{i}"
            layers += [
                Layer(tag + ".conv1", conv_flops(cin, feats, 1, h, w), not frozen, not first),
                Layer(tag + ".conv2", conv_flops(feats, feats, 3, h2, w2), not frozen),
                Layer(tag + ".conv3", conv_flops(feats, 4 * feats, 1, h2, w2), not frozen)]
            if i == 0:
                layers.append(Layer(tag + ".downsample",
                                    conv_flops(cin, 4 * feats, 1, h2, w2), not frozen, not first))
            h, w, cin = h2, w2, 4 * feats
        outs.append((cin, h, w))
        feats *= 2
    return layers, outs


def fpn_rpn_layers(outs, channels: int, anchors: int, frozen_stages: int = 1) -> list:
    layers = []
    levels = []
    for i, (c, h, w) in enumerate(outs):
        detached = i + 1 <= frozen_stages  # C2 leaves a frozen stage
        layers.append(Layer(f"fpn.lateral{i + 2}", conv_flops(c, channels, 1, h, w),
                            input_grad=not detached))
        layers.append(Layer(f"fpn.smooth{i + 2}", conv_flops(channels, channels, 3, h, w)))
        levels.append((h, w))
    h, w = outs[-1][1:]
    levels.append(((h + 1) // 2, (w + 1) // 2))  # P6: P5 subsampled
    for j, (h, w) in enumerate(levels):
        layers += [Layer(f"rpn.conv.p{j + 2}", conv_flops(channels, channels, 3, h, w)),
                   Layer(f"rpn.cls.p{j + 2}", conv_flops(channels, anchors, 1, h, w)),
                   Layer(f"rpn.box.p{j + 2}", conv_flops(channels, 4 * anchors, 1, h, w))]
    return layers


def box_head_layers(rois: int, channels: int, pool: int, classes: int) -> list:
    d = channels * pool * pool
    return [Layer("box.fc1", 2.0 * rois * d * 1024), Layer("box.fc2", 2.0 * rois * 1024 * 1024),
            Layer("box.cls", 2.0 * rois * 1024 * classes),
            Layer("box.reg", 2.0 * rois * 1024 * 4 * classes)]


def mask_head_layers(rois: int, channels: int, pool: int, classes: int) -> list:
    layers = [Layer(f"mask.conv{i}", rois * conv_flops(channels, channels, 3, pool, pool))
              for i in range(4)]
    # a 2x2 / 2 transposed convolution: each input cell feeds 4 outputs
    layers.append(Layer("mask.deconv", rois * conv_flops(channels, channels, 2, pool, pool)))
    layers.append(Layer("mask.logits", rois * conv_flops(channels, classes - 1, 1, 2 * pool,
                                                        2 * pool)))
    return layers


def model_layers(s: dict, train: bool, canvas=None) -> list:
    """Every layer of one image's pass under settings ``s``."""
    canvas = canvas or s["canvas"]
    frozen = s["frozen_stages"]
    layers, outs = backbone_layers(s["backbone"], canvas, frozen)
    layers += fpn_rpn_layers(outs, s["fpn_channels"], len(s["anchor_ratios"]), frozen)
    if train:
        rois = s["roi_batch_per_image"]
        masks = max(int(s["roi_batch_per_image"] * s["roi_positive_fraction"]), 1)
    else:
        rois, masks = s["post_nms_topk_test"], s["detections_per_image"]
    layers += box_head_layers(rois, s["fpn_channels"], s["pool_size"], s["num_classes"])
    layers += mask_head_layers(masks, s["fpn_channels"], s["mask_pool_size"], s["num_classes"])
    return layers


def image_flops(s: dict, train: bool, canvas=None) -> float:
    """FLOPs of one image's inference, or of its share of a training step."""
    layers = model_layers(s, train, canvas)
    return sum(x.train_flops() if train else x.flops for x in layers)
