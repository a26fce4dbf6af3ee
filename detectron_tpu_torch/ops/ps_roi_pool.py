"""Position-sensitive RoI pooling (R-FCN).

The port of ``detectron_tpu/ops/ps_roi_pool.py``: features carry ``P*P``
channel groups of ``K`` channels; output bin ``(i, j)`` averages *its own*
group's channels over the bin. Each bin is ``S x S`` bilinear samples
(RoIAlign's sampling and Caffe2 border rule, ``aligned=False``, RoI extent
at least one cell), so sample ``(a, b)`` of the ``P*S x P*S`` grid reads
channel group ``(a // S) * P + (b // S)``, samples outside ``[-1, size]``
give 0, and each bin is the mean of its ``S x S`` block.

The reference computes it in plain JAX, not in a Pallas kernel, and so does
the port in plain PyTorch: the features as a ``[H*W*P*P, K]`` table whose
row ``pixel * P*P + group`` every sample's four corners gather, and the
gradient by autograd (the gather's backward is an accumulating scatter).
Means divide by a tensor (``ops.boxes.true_div``), not by a Python number,
so that CUDA rounds as the CPU and JAX do.
"""

from __future__ import annotations

import torch

from detectron_tpu_torch.ops.boxes import true_div
from detectron_tpu_torch.ops.roi_align import _bilinear_1d, _sample_coords


def ps_roi_pool(feature: torch.Tensor, rois: torch.Tensor, stride: int,
                output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """``feature [B, H, W, P*P*K]`` (NHWC) and image-coordinate ``rois
    [B, R, 4]`` give ``[B, R, P, P, K]``."""
    b, h, w, cin = feature.shape
    p, s = output_size, sampling_ratio
    if cin % (p * p):
        raise ValueError(f"ps_roi_pool: {cin} channels, not a multiple of P*P = {p * p}")
    k = cin // (p * p)
    r = rois.shape[1]
    dev = rois.device
    table = feature.reshape(b, h * w * p * p, k)
    grid = torch.arange(p * s, device=dev) // s  # made on the device: no wait for it
    group = grid[:, None] * p + grid[None, :]  # [PS, PS]
    scale = 1.0 / stride
    x1 = rois[..., 0] * scale
    y1 = rois[..., 1] * scale
    rw = (rois[..., 2] * scale - x1).clamp_min(1.0)
    rh = (rois[..., 3] * scale - y1).clamp_min(1.0)
    x0, x1i, wx0, wx1, xin = _bilinear_1d(_sample_coords(x1, rw, p, s),
                                          torch.full((), float(w), device=dev))
    y0, y1i, wy0, wy1, yin = _bilinear_1d(_sample_coords(y1, rh, p, s),
                                          torch.full((), float(h), device=dev))
    bidx = torch.arange(b, device=dev)[:, None, None, None]

    def corner(yi, xi, wy, wx):
        row = (yi[..., :, None] * w + xi[..., None, :]) * (p * p) + group  # [B, R, PS, PS]
        return table[bidx, row] * (wy[..., :, None] * wx[..., None, :])[..., None]

    acc = (corner(y0, x0, wy0, wx0) + corner(y0, x1i, wy0, wx1)
           + corner(y1i, x0, wy1, wx0) + corner(y1i, x1i, wy1, wx1))
    inb = (yin[..., :, None] & xin[..., None, :])[..., None]
    acc = torch.where(inb, acc, torch.zeros_like(acc))
    return true_div(acc.reshape(b, r, p, s, p, s, k).sum(dim=(3, 5)), s * s)
