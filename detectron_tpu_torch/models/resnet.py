"""ResNet-50/101 backbone with frozen BatchNorm.

The port of ``detectron_tpu/models/resnet.py``: torchvision v1.5
bottlenecks (stride on the 3x3, downsample on block 0), a 7x7/2 stem with
symmetric padding 3 and a 3x3/2 max-pool with padding 1. Modules run
NCHW.

Module names follow the JAX parameter tree (``conv1``, ``bn1``,
``layer{s}.{i}.conv1..3 / bn1..3 / downsample_conv / downsample_bn``), so
``utils.weights.from_jax_params`` is a name map.

``dtype`` is the compute dtype (``model.dtype``): the stem casts the
images to it, every convolution computes in it and frozen BatchNorm
applies its float32 scale and bias cast to it; parameters and statistics
stay float32 (``models/precision.py``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.models.precision import Conv2d

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """BatchNorm frozen at its statistics:
    ``y = (x - mean) / sqrt(var + eps) * weight + bias``, with the scale and
    bias worked out in float32 and cast to ``dtype`` (the JAX module's
    ``scale.astype(dtype)``)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        dt = self.compute_dtype
        return x * scale.to(dt)[None, :, None, None] + bias.to(dt)[None, :, None, None]


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         dtype: torch.dtype = torch.float32, dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=dilation * (kernel - 1) // 2,
                  dilation=dilation, bias=False, compute_dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1, expansion 4."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = conv(cin, features, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(features, dtype=dtype)
        self.conv2 = conv(features, features, 3, stride, dtype=dtype, dilation=dilation)
        self.bn2 = FrozenBatchNorm(features, dtype=dtype)
        self.conv3 = conv(features, features * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(features * 4, dtype=dtype)
        if downsample:
            self.downsample_conv = conv(cin, features * 4, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(features * 4, dtype=dtype)
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


def resnet_param_is_frozen(name: str, frozen_stages: int = 1) -> bool:
    """True for a backbone parameter that training keeps fixed: the stem
    ``conv1`` and every parameter of the stages ``<= frozen_stages``
    (``detectron_tpu/models/resnet.py::resnet_param_is_frozen``; the frozen
    BatchNorm statistics are buffers here, never parameters)."""
    if name.startswith("conv1."):
        return True
    return any(name.startswith(f"layer{s}.") for s in range(1, frozen_stages + 1))


class ResNet(nn.Module):
    """NCHW images -> ``{"c2", "c3", "c4", "c5"}`` (strides 4/8/16/32; c5
    at 16 with ``dilate_c5``).

    The parameters that :func:`resnet_param_is_frozen` names are made with
    ``requires_grad=False``: no gradient reaches them, as the JAX
    package's ``stop_gradient`` after the frozen stages and its optimizer
    mask give. ``remat`` is accepted and changes nothing; ``stem="s2d"``
    is an exact re-layout of the same 7x7/2 conv, so it runs as the plain
    stem.

    ``dilate_c5`` is the a-trous res5 of R-FCN's paper trunk: stage 4
    keeps stride 16 (its first block's 3x3 and downsample convs stride 1)
    and dilates **every** one of its 3x3 convs by 2, the first block's
    too, as the JAX package does (torchvision's
    ``replace_stride_with_dilation`` leaves the first block at dilation
    1). The weights' shapes are unchanged; c5 comes out at stride 16.
    """

    def __init__(self, depth: str = "resnet50", frozen_stages: int = 1,
                 norm: str = "frozen_bn", stem: str = "conv",
                 dilate_c5: bool = False, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm != "frozen_bn":
            raise NotImplementedError(
                f"model.norm={norm!r} (GroupNorm backbone) is not ported yet: "
                "ROADMAP.md, Queue 1, backbone variants")
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.conv1 = conv(3, 64, 7, stride=2, dtype=dtype)  # casts the images
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        cin, features = 64, 64
        for stage, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            blocks = []
            dilated = stage == 3 and dilate_c5
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0 and not dilated) else 1
                blocks.append(Bottleneck(cin, features, stride, downsample=(i == 0),
                                         dtype=dtype, dilation=2 if dilated else 1))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2
        self.out_channels = [256, 512, 1024, 2048]
        for name, param in self.named_parameters():
            if resnet_param_is_frozen(name, frozen_stages):
                param.requires_grad_(False)

    def forward(self, x, stages: int = 4):
        """The outputs of the first ``stages`` stages (R-FCN's C4 trunk runs
        three)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage in range(stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats[f"c{stage + 2}"] = x
        return feats
