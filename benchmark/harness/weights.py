"""Random weights from a seed, made on the device in one draw.

Every leaf of the state dict comes out of one ``torch.randn`` on the
device (a ``torch.Generator`` seeded from ``--seed``), scaled per leaf as
the program's own initializers scale it: He fan-out for the backbone and
the mask convolutions, LeCun fan-in elsewhere, small normals for the
prediction layers, zero biases. The parameters are float32, as the
program keeps its master copy; it computes in bf16.

Then, with the plain reference's own forward (never the program's):

* frozen BatchNorm's statistics are set from the calibration images, one
  layer at a time in order, as a pretrained backbone's normalize its
  activations (with identity statistics a random ResNet's activations
  grow at every residual add, and SGD overflows within a few steps);
* for inference, the objectness and class logits are scaled to spread
  across anchors and RoIs as a trained detector's do, and the class
  biases set so that the detection slots fill above the score threshold
  (what a COCO-trained model does on most val images). Random weights
  at their initial scale give every anchor and RoI nearly the same logit,
  and ties decided by rounding then choose the boxes.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref


def init_std(name: str, shape) -> float:
    """The standard deviation of one weight's initial draw."""
    if name.startswith(("rpn_head.", "box_head.cls_score")):
        return 0.01
    if name.startswith(("box_head.bbox_pred", "mask_head.mask_logits")):
        return 0.001
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    if name.startswith(("backbone.", "mask_head.conv")):
        return math.sqrt(2.0 / (shape[0] * receptive))
    if name.startswith("mask_head.deconv"):
        return math.sqrt(1.0 / (shape[0] * receptive))
    return math.sqrt(1.0 / (shape[1] * receptive))


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``salt``) of ``seed``; any
    whole number seeds it."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63 - 1))
    return g


def random_params(shapes: dict, seed: int, device, residual_gamma: float = 1.0) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` (``{name: shape}``, the
    program's state dict layout): weights drawn, biases 0, BatchNorm at
    identity but for the scale of each bottleneck's last BatchNorm,
    ``residual_gamma``: a trained ResNet's residual branches add a fraction
    of their input, where a random one at scale 1 amplifies any rounding
    from block to block (its activations are chaotic in depth)."""
    draw = [n for n, s in shapes.items() if n.endswith(".weight") and len(s) > 1]
    total = sum(math.prod(shapes[n]) for n in draw)
    flat = torch.randn(total, generator=generator(seed, 1, device), device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name in draw:
            n = math.prod(shape)
            params[name] = flat[at:at + n].view(shape).mul_(init_std(name, shape))
            at += n
        elif name.endswith("bn3.weight"):
            params[name] = torch.full(shape, float(residual_gamma), device=device)
        elif name.endswith("running_var") or name.endswith(".weight"):
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


class _Calibrating(ref.Net):
    """The reference network, setting each frozen BatchNorm's statistics
    from its own input before applying it."""

    def bn(self, name, x):
        self.p[name + ".running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        self.p[name + ".running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return super().bn(name, x)


@torch.no_grad()
def calibrate_frozen_bn(params: dict, mcfg: dict, images: torch.Tensor) -> None:
    """Frozen BatchNorm statistics of ``images`` (NHWC), in place."""
    _Calibrating(params, mcfg).backbone(images.permute(0, 3, 1, 2))


@torch.no_grad()
def calibrate_logits(params: dict, mcfg: dict, images, image_hw, logits: dict) -> None:
    """Scales the RPN objectness, class-score and mask-logit weights so that
    their logits have the standard deviations ``logits["objectness_std"]``,
    ``logits["class_std"]`` and ``logits["mask_std"]`` over these images'
    anchors, proposals and detections, and sets the class biases:
    ``logits["background_bias"]`` for class 0, ``logits["class_bias"]`` for
    the others; the class-specific box deltas are scaled to the standard
    deviation ``logits["box_delta_std"]`` (in the units the box weights
    normalize to, where a trained head's regression targets spread about
    1). In place."""
    net = ref.Net(params, mcfg)
    levels = net.features(images)
    scores, deltas = net.rpn(levels)
    obj = torch.cat(scores, 1)
    w = params["rpn_head.objectness.weight"]
    w.mul_(logits["objectness_std"] / obj.std().clamp_min(1e-12))
    scores, deltas = net.rpn(levels)
    props, valid = ref.eval_proposals(mcfg, scores, deltas, image_hw, images.shape[1:3])
    cls_logits, reg = net.box(levels, props)
    spread = cls_logits[valid][:, 1:].std().clamp_min(1e-12)
    params["box_head.cls_score.weight"].mul_(logits["class_std"] / spread)
    spread = reg[valid][:, 1:].std().clamp_min(1e-12)
    params["box_head.bbox_pred.weight"].mul_(logits["box_delta_std"] / spread)
    bias = params["box_head.cls_score.bias"]
    bias.fill_(logits["class_bias"])
    bias[0] = logits["background_bias"]
    cls_logits, reg = net.box(levels, props)
    dets = ref.detect(cls_logits, reg, props, valid, image_hw, mcfg)
    own = ref.own_class_probs(net.mask(levels, dets.boxes), dets.classes)
    spread = torch.logit(own[dets.valid].clamp(1e-6, 1 - 1e-6)).std().clamp_min(1e-12)
    params["mask_head.mask_logits.weight"].mul_(logits["mask_std"] / spread)
