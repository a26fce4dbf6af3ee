"""Feature Pyramid Network neck.

The port of ``detectron_tpu/models/fpn.py`` for the two-stage detectors
(``levels="p2p6"``): lateral 1x1 convs to ``channels``, a top-down pathway
of 2x nearest upsampling and adds, 3x3 smoothing convs giving P2..P5, and
P6 as the stride-2 subsample of P5 (``max_pool`` with a 1x1 window).
Every convolution, upsample and add runs in the compute ``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.models.precision import Conv2d


class FPN(nn.Module):
    """``{"c2".."c5"}`` (NCHW) -> ``[P2, P3, P4, P5, P6]`` (NCHW)."""

    def __init__(self, in_channels, channels: int = 256, levels: str = "p2p6",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if levels != "p2p6":
            raise NotImplementedError(
                f"FPN levels {levels!r} (RetinaNet's P3-P7) are not ported yet: "
                "ROADMAP.md, Queue 1, RetinaNet")
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", Conv2d(cin, channels, 1, compute_dtype=dtype))
            self.add_module(f"smooth{i + 2}", Conv2d(channels, channels, 3, padding=1,
                                                     compute_dtype=dtype))

    def forward(self, feats: dict) -> list:
        lateral = [getattr(self, f"lateral{i + 2}")(feats[f"c{i + 2}"])
                   for i in range(4)]
        tds = [lateral[-1]]
        for lat in reversed(lateral[:-1]):
            tds.append(lat + F.interpolate(tds[-1], scale_factor=2, mode="nearest"))
        tds = tds[::-1]  # finest first
        ps = [getattr(self, f"smooth{i + 2}")(t) for i, t in enumerate(tds)]
        return ps + [ps[-1][:, :, ::2, ::2]]
