"""Mask R-CNN with a ResNeXt-FPN backbone, in plain PyTorch.

Xie et al.'s ResNeXt (arXiv:1611.05431) as the trunk of
``reference/model.py``'s Mask R-CNN, as Detectron's
``e2e_mask_rcnn_X-101-64x4d-FPN_1x`` configures it (``RESNETS``:
``NUM_GROUPS: 64``, ``WIDTH_PER_GROUP: 4``, ``STRIDE_1X1: False``,
``TRANS_FUNC: bottleneck_transformation``): each bottleneck is 1x1 ->
grouped 3x3 -> 1x1, its inner width ``groups * width_per_group *
2**stage`` (256, 512, 1024, 2048 for 64x4d), the stride on the 3x3 and
the output widths those of the ResNet (256 to 2048). Everything after the
trunk is ``reference/model.py``'s.

Departures from the paper: frozen BatchNorm (its statistics and affine
fixed, as Detectron fine-tunes), which every configuration here shares;
none beyond it. The paper's form (C), one grouped convolution, is what
it computes: its forms (A) and (B) are the same function.

Every function takes the state dict of float32 tensors under the
program's parameter names and a ``numerics`` (``"fp32"``: float32 with
TF32 off, the reference; ``"fp8"``: the control), as
``reference/model.py``'s do. Nothing here imports the program.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference import model

# name -> (blocks a stage, groups, channels a group at res2)
TRUNKS = {"resnext101_64x4d": ((3, 4, 23, 3), 64, 4),
          "resnet50": ((3, 4, 6, 3), 1, 64), "resnet101": ((3, 4, 23, 3), 1, 64)}


class Net(model.Net):
    """``reference/model.py``'s network with grouped 3x3 convolutions in
    its bottlenecks."""

    def conv(self, name, x, stride=1, padding=0, bias=True, groups=1):
        w = self.p[name + ".weight"]
        b = self.p[name + ".bias"] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding,
                               groups=groups))

    def bottleneck(self, name, x, stride, downsample, groups=1):
        out = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x, bias=False)))
        out = F.relu(self.bn(name + ".bn2", self.conv(name + ".conv2", out, stride, 1,
                                                      bias=False, groups=groups)))
        out = self.bn(name + ".bn3", self.conv(name + ".conv3", out, bias=False))
        if downsample:
            x = self.bn(name + ".downsample_bn",
                        self.conv(name + ".downsample_conv", x, stride, bias=False))
        return F.relu(self.q(out + x))

    def backbone(self, x, frozen_stages: int = 1):
        """NCHW images -> C2..C5; the stem and the frozen stages' output is
        detached (they take no gradient)."""
        x = F.relu(self.bn("backbone.bn1", self.conv("backbone.conv1", x, 2, 3, bias=False)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        stage_blocks, groups, _ = TRUNKS[self.m["backbone"]]
        feats = []
        for stage, blocks in enumerate(stage_blocks):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                x = self.bottleneck(f"backbone.layer{stage + 1}.{i}", x, stride, i == 0,
                                    groups)
            if stage + 1 <= frozen_stages:
                x = x.detach()
            feats.append(x)
        return feats


@torch.no_grad()
def predict(params, mcfg, images, image_hw, numerics: str = "fp32") -> dict:
    """``reference/model.py::predict`` over this trunk."""
    net = Net(params, mcfg, numerics)
    levels = net.features(images)
    rpn = net.rpn(levels)
    props = model.eval_proposals(mcfg, *rpn, image_hw, images.shape[1:3])
    box = net.box(levels, props[0])
    dets = model.detect(*box, *props, image_hw, mcfg)
    masks = model.own_class_probs(net.mask(levels, dets.boxes), dets.classes)
    return {"rpn": rpn, "proposals": props, "box": box, "dets": dets, "masks": masks}


@torch.no_grad()
def follow(params, mcfg, images, image_hw, side: dict) -> dict:
    """``reference/model.py::follow`` over this trunk: each stage on the
    inputs that ``side``'s stages handed each other."""
    net = Net(params, mcfg)
    levels = net.features(images)
    props = side["proposals"]
    dets = side["dets"]
    return {"rpn": net.rpn(levels),
            "proposals": model.eval_proposals(mcfg, *side["rpn"], image_hw, images.shape[1:3]),
            "box": net.box(levels, props[0]),
            "dets": model.detect(*side["box"], *props, image_hw, mcfg),
            "masks": model.own_class_probs(net.mask(levels, dets.boxes), dets.classes)}


class _Calibrating(Net):
    """The network, setting each frozen BatchNorm's statistics from its own
    input before applying it."""

    def bn(self, name, x):
        self.p[name + ".running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        self.p[name + ".running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return super().bn(name, x)


@torch.no_grad()
def calibrate_frozen_bn(params: dict, mcfg: dict, images: torch.Tensor) -> None:
    """Frozen BatchNorm statistics of ``images`` (NHWC), in place, one layer
    at a time in order (``harness/weights.py::calibrate_frozen_bn`` over
    this trunk)."""
    _Calibrating(params, mcfg).backbone(images.permute(0, 3, 1, 2))
