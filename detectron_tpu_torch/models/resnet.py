"""ResNet-50/101 backbone with frozen BatchNorm.

The port of ``detectron_tpu/models/resnet.py``: torchvision v1.5
bottlenecks (stride on the 3x3, downsample on block 0), a 7x7/2 stem with
symmetric padding 3 and a 3x3/2 max-pool with padding 1. Modules run
NCHW.

Module names follow the JAX parameter tree (``conv1``, ``bn1``,
``layer{s}.{i}.conv1..3 / bn1..3 / downsample_conv / downsample_bn``), so
``utils.weights.from_jax_params`` is a name map.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """BatchNorm frozen at its statistics:
    ``y = (x - mean) / sqrt(var + eps) * weight + bias``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


def conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                     bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, expansion 4."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = conv(features, features, 3, stride)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = conv(features, features * 4, 1)
        self.bn3 = FrozenBatchNorm(features * 4)
        if downsample:
            self.downsample_conv = conv(cin, features * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(features * 4)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """NCHW images -> ``{"c2", "c3", "c4", "c5"}`` (strides 4/8/16/32).

    ``frozen_stages`` and ``remat`` only concern training and are accepted
    as they are; ``stem="s2d"`` is an exact re-layout of the same 7x7/2
    conv, so it runs as the plain stem.
    """

    def __init__(self, depth: str = "resnet50", frozen_stages: int = 1,
                 norm: str = "frozen_bn", stem: str = "conv",
                 dilate_c5: bool = False, remat: bool = False):
        super().__init__()
        if norm != "frozen_bn":
            raise NotImplementedError(
                f"model.norm={norm!r} (GroupNorm backbone) is not ported yet: "
                "ROADMAP.md, Queue 1, backbone variants")
        if dilate_c5:
            raise NotImplementedError(
                "model.dilate_c5 (a-trous res5) is not ported yet: ROADMAP.md, "
                "Queue 1, backbone variants")
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, features = 64, 64
        for stage, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(cin, features, stride, downsample=(i == 0)))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2
        self.out_channels = [256, 512, 1024, 2048]

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats[f"c{stage + 2}"] = x
        return feats
