"""Feature Pyramid Network neck.

The port of ``detectron_tpu/models/fpn.py``: lateral 1x1 convs to
``channels``, a top-down pathway of 2x nearest upsampling and adds, 3x3
smoothing convs. Extra levels:

* ``levels="p2p6"`` (Faster / Mask R-CNN): P2..P5, and P6 as the stride-2
  subsample of P5 (``max_pool`` with a 1x1 window);
* ``levels="p3p7"`` (RetinaNet): P3..P5, P6 a 3x3/2 conv on C5 and P7 a
  3x3/2 conv on ``relu(P6)``, each padded as flax pads ``"SAME"`` at
  stride 2 (:func:`pad_same_stride2`). The JAX module also makes
  ``lateral2`` and ``smooth2`` here, whose P2 it never returns; the port
  makes neither (``utils/weights.py`` drops them).

Every convolution, upsample and add runs in the compute ``dtype``; each
convolution's bias, and the top-down add after a lateral, go through
:func:`~detectron_tpu_torch.models.precision.conv_bias_act` (one pass at
inference).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.models.precision import Conv2d, conv_bias_act

LEVELS = ("p2p6", "p3p7")


def pad_same_stride2(x: torch.Tensor) -> torch.Tensor:
    """Pads NCHW ``x`` for a 3x3/2 convolution as flax's ``"SAME"`` does: a
    total of ``(ceil(n/2) - 1) * 2 + 3 - n`` per side, split ``(total // 2,
    total - total // 2)``: ``(0, 1)`` on an even side, ``(1, 1)`` on an odd
    one. (A symmetric ``padding=1`` shifts the even sides' windows by one.)"""
    h, w = x.shape[-2:]
    return F.pad(x, (w % 2, 1, h % 2, 1))


class FPN(nn.Module):
    """``{"c2".."c5"}`` (NCHW) -> ``[P2, P3, P4, P5, P6]`` (``"p2p6"``) or
    ``[P3, P4, P5, P6, P7]`` (``"p3p7"``), NCHW."""

    def __init__(self, in_channels, channels: int = 256, levels: str = "p2p6",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if levels not in LEVELS:
            raise ValueError(f"FPN levels {levels!r}: want one of {LEVELS}")
        self.levels = levels
        self.first = 2 if levels == "p2p6" else 3  # the finest C level that is read
        for i, cin in enumerate(in_channels):
            if i + 2 < self.first:
                continue
            self.add_module(f"lateral{i + 2}", Conv2d(cin, channels, 1, compute_dtype=dtype))
            self.add_module(f"smooth{i + 2}", Conv2d(channels, channels, 3, padding=1,
                                                     compute_dtype=dtype))
        if levels == "p3p7":
            self.p6 = Conv2d(in_channels[-1], channels, 3, stride=2, compute_dtype=dtype)
            self.p7 = Conv2d(channels, channels, 3, stride=2, compute_dtype=dtype)

    def forward(self, feats: dict) -> list:
        first = self.first
        tds = [conv_bias_act(self.lateral5, feats["c5"])]
        for i in range(4, first - 1, -1):  # lateral + 2x nearest of the merged level above
            tds.append(conv_bias_act(getattr(self, f"lateral{i}"), feats[f"c{i}"],
                                     coarse=tds[-1]))
        tds = tds[::-1]  # finest first
        ps = [conv_bias_act(getattr(self, f"smooth{first + i}"), t) for i, t in enumerate(tds)]
        if self.levels == "p2p6":
            return ps + [ps[-1][:, :, ::2, ::2]]
        p6 = self.p6(pad_same_stride2(feats["c5"]))
        p7 = self.p7(pad_same_stride2(F.relu(p6)))
        return ps + [p6, p7]
