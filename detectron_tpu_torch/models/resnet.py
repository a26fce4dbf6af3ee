"""ResNet-50/101 and ResNeXt-101 64x4d backbones with frozen BatchNorm or
trainable GroupNorm-32.

The port of ``detectron_tpu/models/resnet.py``: torchvision v1.5
bottlenecks (stride on the 3x3, downsample on block 0), a 7x7/2 stem with
symmetric padding 3 and a 3x3/2 max-pool with padding 1. Modules run
NCHW. ``model.backbone`` names a trunk of :data:`TRUNKS`: its blocks a
stage, and the groups and width a group of each bottleneck's 3x3
(ResNeXt, Xie et al., arXiv:1611.05431: 1x1 -> grouped 3x3 -> 1x1, the
inner width ``groups * width_per_group * 2**stage``, as torchvision's
``resnext101_64x4d`` and Detectron's ``X-101-64x4d`` build it). A plain
ResNet is the trunk with one group of 64 channels; the JAX package has
ResNet alone.

Module names follow the JAX parameter tree (``conv1``, ``bn1``,
``layer{s}.{i}.conv1..3 / bn1..3 / downsample_conv / downsample_bn``; with
``norm="gn"`` the norms are ``gn1..3`` / ``downsample_gn`` and the stem's
``gn1``, as ``make_norm`` names them), so ``utils.weights.from_jax_params``
is a name map.

``dtype`` is the compute dtype (``model.dtype``): the stem casts the
images to it, every convolution computes in it and frozen BatchNorm
applies its float32 scale and bias cast to it; GroupNorm normalizes in
float32 and rounds its output to it once; parameters and statistics stay
float32 (``models/precision.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from detectron_tpu_torch.models.precision import Conv2d
from detectron_tpu_torch.ops.frozen_bn import frozen_bn_act
from detectron_tpu_torch.utils.spans import span


class Trunk(NamedTuple):
    """A bottleneck trunk: blocks a stage (res2-res5), and the groups and
    channels a group of each stage-2 bottleneck's 3x3 (doubled a stage)."""

    blocks: tuple[int, int, int, int]
    groups: int = 1
    width_per_group: int = 64

    def inner(self, stage: int) -> int:
        """The 1x1 -> 3x3 -> 1x1 inner width of stage ``stage`` (0 = res2)."""
        return self.groups * self.width_per_group * 2 ** stage


TRUNKS = {
    "resnet50": Trunk((3, 4, 6, 3)),
    "resnet101": Trunk((3, 4, 23, 3)),
    "resnext101_64x4d": Trunk((3, 4, 23, 3), groups=64, width_per_group=4),
}
STAGE_BLOCKS = {name: trunk.blocks for name, trunk in TRUNKS.items()}


class FrozenBatchNorm(nn.Module):
    """BatchNorm frozen at its statistics, with the ReLU that follows it:
    ``relu((x - mean) / sqrt(var + eps) * weight + bias [+ residual])``,
    the scale and bias worked out in float32 and cast to ``dtype`` (the JAX
    module's ``scale.astype(dtype)``).

    A call is one pass of ``ops/frozen_bn.py::frozen_bn_act`` (the kernel of
    ``csrc/frozen_bn.cu`` on the card): ``norm(x)``, ``norm(x, r)`` with
    an identity residual, or ``norm(x, d, downsample_norm)`` with the raw
    downsample conv output ``d``, to which ``downsample_norm``'s scale and
    bias are applied in the same pass. The result is bit for bit the eager
    ``x * scale + bias``, residual add and ``F.relu``.

    The scale and bias are kept between calls, and worked out again when a
    buffer is replaced or written in place (its ``_version``):
    ``load_state_dict``, ``copy_`` and ``.to`` all do one or the other."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self._cached = None  # (key, the buffers it names, scale, bias)

    def scale_bias(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``[C]`` scale and bias in the compute dtype."""
        buffers = (self.weight, self.bias, self.running_mean, self.running_var)
        key = None  # an inference tensor tracks no version: never cached
        if not any(t.is_inference() for t in buffers):
            # the cache holds the buffers, so their ids name no other tensor
            key = (self.compute_dtype, self.eps, tuple(map(id, buffers)),
                   tuple(t._version for t in buffers))
        cached = self._cached
        if key is None or cached is None or cached[0] != key:
            with torch.no_grad():
                scale = self.weight * torch.rsqrt(self.running_var + self.eps)
                bias = self.bias - self.running_mean * scale
                dt = self.compute_dtype
                cached = (key, buffers, scale.to(dt), bias.to(dt))
            self._cached = None if key is None else cached
        return cached[2], cached[3]

    def forward(self, x, residual=None, residual_norm: FrozenBatchNorm | None = None):
        scale, bias = self.scale_bias()
        res_scale = res_bias = None
        if residual_norm is not None:
            res_scale, res_bias = residual_norm.scale_bias()
        return frozen_bn_act(x, scale, bias, residual, res_scale, res_bias)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups=32)`` as the JAX package builds it:
    epsilon 1e-6 (``torch.nn.GroupNorm``'s default is 1e-5), float32
    statistics, scale and bias whatever the compute dtype (flax's
    ``force_float32_reductions``), the output rounded to ``dtype`` once.
    flax's variance is ``E[x^2] - E[x]^2`` clipped at 0 and torch's the
    centred mean square: the same value up to rounding (the tests state
    the tolerance). ``memory_format`` is the layout the output is written
    in, with the cast, in one pass."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(32, features, eps=1e-6)
        self.compute_dtype = dtype
        self.memory_format = torch.contiguous_format

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype, memory_format=self.memory_format)


NORMS = ("frozen_bn", "gn")


def make_norm(kind: str, features: int, dtype: torch.dtype) -> nn.Module:
    """``"frozen_bn"`` (the reference's fine-tune semantics) or ``"gn"``
    (trainable GroupNorm-32)."""
    if kind == "gn":
        return GroupNorm(features, dtype=dtype)
    return FrozenBatchNorm(features, dtype=dtype)


def norm_name(kind: str, name: str) -> str:
    """The JAX module's name of a norm: ``bn*`` becomes ``gn*`` for GroupNorm."""
    return name.replace("bn", "gn") if kind == "gn" else name


def norm_act(norm: nn.Module, x, residual=None, residual_norm: nn.Module | None = None):
    """``relu(norm(x) + residual_norm(residual))``, the residual and its norm
    optional: one pass for frozen BatchNorm (:class:`FrozenBatchNorm`, which
    takes the residual's norm as its own argument, so that a forward
    pre-hook sees both norms' inputs), the eager ops for GroupNorm."""
    if isinstance(norm, FrozenBatchNorm):
        return norm(x, residual, residual_norm)
    y = norm(x)
    if residual is not None:
        y = y + (residual if residual_norm is None else residual_norm(residual))
    return F.relu(y)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         dtype: torch.dtype = torch.float32, dilation: int = 1, groups: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=dilation * (kernel - 1) // 2,
                  dilation=dilation, groups=groups, bias=False, compute_dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation, ``groups``) -> 1x1, out ``features * 4``;
    ``inner`` is the 1x1 -> 3x3 -> 1x1 width (``features`` for a ResNet).
    A grouped 3x3 is the span ``grouped 3x3`` (``utils/spans.py``)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32,
                 dilation: int = 1, norm: str = "frozen_bn", groups: int = 1,
                 inner: int | None = None):
        super().__init__()
        inner = features if inner is None else inner
        self.groups = groups
        self.norm_names = [norm_name(norm, f"bn{i}") for i in (1, 2, 3)]
        self.conv1 = conv(cin, inner, 1, dtype=dtype)
        self.add_module(self.norm_names[0], make_norm(norm, inner, dtype))
        self.conv2 = conv(inner, inner, 3, stride, dtype=dtype, dilation=dilation,
                          groups=groups)
        self.add_module(self.norm_names[1], make_norm(norm, inner, dtype))
        self.conv3 = conv(inner, features * 4, 1, dtype=dtype)
        self.add_module(self.norm_names[2], make_norm(norm, features * 4, dtype))
        self.downsample_name = norm_name(norm, "downsample_bn")
        if downsample:
            self.downsample_conv = conv(cin, features * 4, 1, stride, dtype=dtype)
            self.add_module(self.downsample_name, make_norm(norm, features * 4, dtype))
        else:
            self.downsample_conv = None

    def forward(self, x):
        n1, n2, n3 = (getattr(self, n) for n in self.norm_names)
        out = norm_act(n1, self.conv1(x))
        if self.groups > 1:
            with span("grouped 3x3"):
                out = self.conv2(out)
        else:
            out = self.conv2(out)
        out = norm_act(n2, out)
        if self.downsample_conv is None:
            return norm_act(n3, self.conv3(out), x)
        return norm_act(n3, self.conv3(out), self.downsample_conv(x),
                        getattr(self, self.downsample_name))


def resnet_param_is_frozen(name: str, frozen_stages: int = 1) -> bool:
    """True for a backbone parameter that training keeps fixed: the stem
    ``conv1`` and every parameter of the stages ``<= frozen_stages``
    (``detectron_tpu/models/resnet.py::resnet_param_is_frozen``; the frozen
    BatchNorm statistics are buffers here, never parameters). The stem's
    GroupNorm ``gn1`` is trainable, as under the JAX rule, which freezes
    "bn" names only; with ``frozen_stages >= 1`` no gradient reaches it
    (:class:`ResNet` detaches the last frozen stage's output)."""
    if name.startswith("conv1."):
        return True
    return any(name.startswith(f"layer{s}.") for s in range(1, frozen_stages + 1))


class ResNet(nn.Module):
    """NCHW images -> ``{"c2", "c3", "c4", "c5"}`` (strides 4/8/16/32; c5
    at 16 with ``dilate_c5``).

    The parameters that :func:`resnet_param_is_frozen` names are made with
    ``requires_grad=False``, and the output of the last frozen stage is
    detached, as the JAX package's ``stop_gradient`` there and its
    optimizer mask give: no gradient reaches the frozen stages or the
    stem (its trainable GroupNorm included). ``stem="s2d"`` is an exact
    re-layout of the same 7x7/2 conv, so it runs as the plain stem.

    ``depth``: a trunk of :data:`TRUNKS` (``model.backbone``). Each stage
    runs in a span ``res2`` to ``res5`` (``utils/spans.py``), inside the
    caller's own.

    ``norm``: ``"frozen_bn"`` or ``"gn"`` (:class:`GroupNorm`, trainable
    outside the frozen stages). ``remat``: while grad is enabled, each
    bottleneck of a stage above ``frozen_stages`` runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps its input and
    recomputes its inner activations in the backward pass, as
    ``nn.remat`` does in the JAX package; frozen stages are never wrapped.
    The state dict is the same either way.

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
        if norm not in NORMS:
            raise ValueError(f"model.norm={norm!r}: want one of {NORMS}")
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        if depth not in TRUNKS:
            raise ValueError(f"model.backbone={depth!r}: want one of {sorted(TRUNKS)}")
        trunk = TRUNKS[depth]
        self.frozen_stages = frozen_stages
        self.remat = remat
        self.conv1 = conv(3, 64, 7, stride=2, dtype=dtype)  # casts the images
        self.stem_norm = norm_name(norm, "bn1")
        self.add_module(self.stem_norm, make_norm(norm, 64, dtype))
        cin, features = 64, 64
        for stage, num_blocks in enumerate(trunk.blocks):
            blocks = []
            dilated = stage == 3 and dilate_c5
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0 and not dilated) else 1
                blocks.append(Bottleneck(cin, features, stride, downsample=(i == 0),
                                         dtype=dtype, dilation=2 if dilated else 1,
                                         norm=norm, groups=trunk.groups,
                                         inner=trunk.inner(stage)))
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
        x = norm_act(getattr(self, self.stem_norm), self.conv1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage in range(stages):
            layer = getattr(self, f"layer{stage + 1}")
            with span(f"res{stage + 2}"):
                if self.remat and stage + 1 > self.frozen_stages and torch.is_grad_enabled():
                    for block in layer:
                        # no block draws random numbers: no RNG state to keep
                        x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
                else:
                    x = layer(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            feats[f"c{stage + 2}"] = x
        return feats
