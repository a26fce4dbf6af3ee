"""Detection heads: RPN, Fast R-CNN box head, mask head.

The port of ``detectron_tpu/models/heads.py``. The convolutions run NCHW;
outputs keep the JAX layouts: RPN outputs flatten in (h, w, anchor)
order, the box head flattens pooled features in HWC order, and mask
logits come out ``[B, R, 2P, 2P, K-1]``.
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F


class RPNHead(nn.Module):
    """3x3 conv + sibling 1x1 convs: one objectness logit and 4 deltas per
    anchor. Shared across FPN levels."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, x):  # [B, C, H, W]
        t = F.relu(self.conv(x))
        b = x.shape[0]
        logits = self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits, deltas


class BoxHead(nn.Module):
    """2x FC-``hidden`` on pooled RoI features -> (class logits K+1,
    per-class box deltas ``[B, R, K+1, 4]``, or ``[B, R, 1, 4]`` when
    class-agnostic)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 1024,
                 class_agnostic: bool = False):
        super().__init__()
        self.nreg = 1 if class_agnostic else num_classes
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.cls_score = nn.Linear(hidden, num_classes)
        self.bbox_pred = nn.Linear(hidden, self.nreg * 4)

    def forward(self, x):  # [B, R, P, P, C]
        b, r = x.shape[:2]
        x = F.relu(self.fc1(x.reshape(b, r, -1)))
        x = F.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x).reshape(b, r, self.nreg, 4)


class MaskHead(nn.Module):
    """4x conv3x3 + 2x2/2 deconv + 1x1 conv to ``num_classes - 1`` mask
    logits (foreground classes only)."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(in_channels if i == 0 else channels,
                                                  channels, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.mask_logits = nn.Conv2d(channels, num_classes - 1, 1)

    def forward(self, x):  # [B, R, P, P, C]
        b, r, h, w, c = x.shape
        x = x.reshape(b * r, h, w, c).permute(0, 3, 1, 2).contiguous()
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = self.mask_logits(F.relu(self.deconv(x)))
        return x.permute(0, 2, 3, 1).reshape(b, r, 2 * h, 2 * w, -1)
