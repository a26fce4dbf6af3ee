"""Multilevel RoIAlign (forward) over an FPN, with FPN level routing.

The port of the inference path of ``detectron_tpu/ops/roi_align.py``:
per-level NHWC features ``[B, Hl, Wl, C]`` and image-coordinate RoIs
``[B, R, 4]`` give pooled features ``[B, R, P, P, C]``. Semantics are the
JAX package's: ``aligned=False``, RoI extent at least one cell,
``sampling_ratio**2`` samples per bin averaged, and the Caffe2 border rule
(a sample outside ``[-1, size]`` contributes 0, otherwise it is clamped to
``[0, size - 1]``).

:func:`multilevel_roi_align` routes every RoI with :func:`assign_fpn_levels`
and then launches the hand-written kernel of ``csrc/roi_align.cu`` (the
port of ``detectron_tpu/ops/roi_align_pallas.py``) on a CUDA tensor, or
runs :func:`multilevel_roi_align_plain`, the same function in plain
PyTorch, on a CPU tensor. Both take the same level index, so they route
identically by construction.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from detectron_tpu_torch import _build
from detectron_tpu_torch.ops.boxes import true_div

# Routing span of the JAX package's gather and fused paths
# (detectron_tpu/ops/roi_align.py:44).
DEFAULT_MAX_SPAN = (28.0, 36.0)


def assign_fpn_levels(rois: torch.Tensor, num_levels: int, min_level: int,
                      canonical_level: int = 4, canonical_scale: float = 224.0,
                      max_span: tuple[float, float] | None = None) -> torch.Tensor:
    """Per-RoI level index in ``[0, num_levels)``, int32.

    ``k = floor(k0 + log2(sqrt(wh) / 224 + 1e-8))``; with ``max_span =
    (mh, mw)`` an RoI is promoted to the first level where its height and
    width, in cells, are at most ``mh`` and ``mw``.
    """
    w = (rois[..., 2] - rois[..., 0]).clamp_min(0.0)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(0.0)
    scale = torch.sqrt(w * h)
    k = torch.floor(canonical_level + torch.log2(true_div(scale, canonical_scale) + 1e-8))
    k = k.to(torch.int32)
    if max_span is not None:
        mh, mw = max_span
        kh = torch.ceil(torch.log2(true_div(h.clamp_min(1.0), mh)) - 1e-6)
        kw = torch.ceil(torch.log2(true_div(w.clamp_min(1.0), mw)) - 1e-6)
        k = torch.maximum(k, torch.maximum(kh, kw).to(torch.int32))
    return torch.clamp(k - min_level, 0, num_levels - 1).to(torch.int32)


def resolve_window(window, window_w, top_h, top_w):
    """Interpolation window of the JAX package's windowed RoIAlign
    (``detectron_tpu/ops/roi_align.py::resolve_window``): ``window <= 0``
    is 32 raised, 8-aligned, to cover the coarsest pooled level."""
    if window <= 0:
        win_h = max(32, -(-int(top_h) // 8) * 8)
        win_w = window_w if window_w > 0 else max(32, -(-int(top_w) // 8) * 8)
        return win_h, win_w
    return window, (window_w if window_w > 0 else window + 8)


def roi_max_span(cfg, top_hw) -> tuple[float, float]:
    """The routing span that the JAX package uses for ``cfg``, given the
    ``(H, W)`` of the coarsest pooled level.

    ``roi.align_impl=window`` (the default) routes with the window's span,
    ``(win_h - 4, win_w - 4)``; ``align_impl=gather`` and
    ``model.fused_roi_align=on`` route with ``DEFAULT_MAX_SPAN``.
    ``fused_roi_align=auto`` means off, as it does on every backend but a
    TPU.
    """
    if cfg.roi.get("pool_type", "align") == "pool":
        raise NotImplementedError(
            "roi.pool_type=pool (RoIPool) is not ported yet: ROADMAP.md, "
            "Queue 1, RoIPool")
    if cfg.model.get("fused_roi_align", "off") == "on":
        return DEFAULT_MAX_SPAN
    if cfg.roi.get("align_impl", "gather") == "window":
        win_h, win_w = resolve_window(cfg.roi.get("window", -1),
                                      cfg.roi.get("window_w", 0), *top_hw)
        return float(win_h - 4), float(win_w - 4)
    return DEFAULT_MAX_SPAN


def _sample_coords(lo, size, pool: int, ratio: int):
    """Sample coordinates ``[..., pool*ratio]`` along one axis: sample j of
    bin p sits at ``lo + (p + (j + 0.5) / ratio) * size / pool``."""
    bin_size = true_div(size, pool)
    pos = np.repeat(np.arange(pool), ratio) + np.tile((np.arange(ratio) + 0.5) / ratio, pool)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=lo.device)
    return lo[..., None] + pos * bin_size[..., None]


def _bilinear_1d(coord, limit):
    """Indices and weights of 1-D bilinear interpolation with the Caffe2
    border rule; ``limit`` (the axis size, float) broadcasts against
    ``coord``. Returns ``(i0, i1, w0, w1, inb)``."""
    inb = (coord >= -1.0) & (coord <= limit)
    c = torch.minimum(coord.clamp_min(0.0), limit - 1.0)
    hi = (limit - 1.0).to(torch.int64)
    i0 = torch.minimum(torch.floor(c).to(torch.int64).clamp_min(0), hi)
    i1 = torch.minimum(i0 + 1, hi)
    frac = c - i0.to(c.dtype)
    return i0, i1, 1.0 - frac, frac, inb


def multilevel_roi_align_plain(features: Sequence[torch.Tensor], rois: torch.Tensor,
                               levels: torch.Tensor, strides: Sequence[int],
                               output_size: int = 7,
                               sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch version of kernel K2: a gather of the four bilinear
    corners of every sample from the concatenated levels, on any device.
    ``levels [B, R]`` is the routing of :func:`assign_fpn_levels`."""
    p, s = output_size, sampling_ratio
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dev = rois.device
    hs = torch.tensor([f.shape[1] for f in features], device=dev)
    ws = torch.tensor([f.shape[2] for f in features], device=dev)
    offsets = torch.cumsum(hs * ws, 0) - hs * ws
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)  # [B, L, C]
    strides_t = torch.tensor(list(strides), dtype=torch.float32, device=dev)

    lvl = levels.long()
    scale = 1.0 / strides_t[lvl]  # [B, R]
    hl, wl = hs[lvl].float(), ws[lvl].float()
    x1 = rois[..., 0] * scale
    y1 = rois[..., 1] * scale
    rw = (rois[..., 2] * scale - x1).clamp_min(1.0)
    rh = (rois[..., 3] * scale - y1).clamp_min(1.0)
    xs = _sample_coords(x1, rw, p, s)  # [B, R, PS]
    ys = _sample_coords(y1, rh, p, s)
    x0, x1i, wx0, wx1, xin = _bilinear_1d(xs, wl[..., None])
    y0, y1i, wy0, wy1, yin = _bilinear_1d(ys, hl[..., None])
    base = offsets[lvl][..., None, None]  # [B, R, 1, 1]
    wrow = ws[lvl][..., None, None]
    bidx = torch.arange(b, device=dev)[:, None, None, None]

    def corner(yi, xi, wy, wx):
        idx = base + yi[..., :, None] * wrow + xi[..., None, :]  # [B, R, PS, PS]
        vals = flat[bidx, idx]  # [B, R, PS, PS, C]
        return vals * (wy[..., :, None] * wx[..., None, :])[..., None]

    pts = (corner(y0, x0, wy0, wx0) + corner(y0, x1i, wy0, wx1)
           + corner(y1i, x0, wy1, wx0) + corner(y1i, x1i, wy1, wx1))
    inb = (yin[..., :, None] & xin[..., None, :])[..., None]
    pts = torch.where(inb, pts, torch.zeros_like(pts))
    return pts.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))


_MAX_LEVELS = 8


def _roi_align_lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    lib.roi_align_forward.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.roi_align_forward.restype = ctypes.c_int
    return lib


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor], rois: torch.Tensor,
                              levels: torch.Tensor, strides: Sequence[int],
                              output_size: int = 7,
                              sampling_ratio: int = 2) -> torch.Tensor:
    """:func:`multilevel_roi_align_plain` as the CUDA kernel of
    ``csrc/roi_align.cu``: one launch for all RoIs of all levels."""
    f0 = features[0]
    if f0.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bfloat16 RoIAlign kernel is not ported yet: ROADMAP.md, Queue 2, "
            "bf16 kernels")
    num_levels = len(features)
    if not 1 <= num_levels <= _MAX_LEVELS or len(strides) != num_levels:
        raise ValueError(f"{num_levels} levels and {len(strides)} strides: "
                         f"want 1..{_MAX_LEVELS} of each")
    b, r = rois.shape[:2]
    c = f0.shape[-1]
    for f in features:
        if not (f.is_cuda and f.device == rois.device and f.dtype == torch.float32
                and f.dim() == 4 and f.shape[0] == b and f.shape[3] == c
                and f.is_contiguous()):
            raise ValueError("features: contiguous float32 NHWC CUDA tensors on "
                             "the RoIs' device, one batch and channel count")
    if not (rois.is_cuda and rois.dtype == torch.float32 and rois.dim() == 3
            and rois.shape[2] == 4 and rois.is_contiguous()
            and rois.data_ptr() % 16 == 0):
        raise ValueError("rois: a contiguous, 16-byte aligned float32 [B, R, 4] "
                         "CUDA tensor")
    if not (levels.device == rois.device and levels.dtype == torch.int32
            and levels.shape == (b, r) and levels.is_contiguous()):
        raise ValueError("levels: a contiguous int32 [B, R] tensor on the RoIs' "
                         "device")
    p, s = output_size, sampling_ratio
    if p * s > 64 or p < 1 or s < 1:
        raise ValueError(f"output_size * sampling_ratio = {p * s}: the kernel "
                         "takes 1..64 samples per axis")
    out = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    if b * r == 0 or c == 0:
        return out
    lib = _roi_align_lib()
    feats = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
    heights = (ctypes.c_int * num_levels)(*[f.shape[1] for f in features])
    widths = (ctypes.c_int * num_levels)(*[f.shape[2] for f in features])
    strides_c = (ctypes.c_float * num_levels)(*[float(x) for x in strides])
    with torch.cuda.device(rois.device):
        err = lib.roi_align_forward(
            feats, heights, widths, strides_c, num_levels, rois.data_ptr(),
            levels.data_ptr(), out.data_ptr(), b * r, r, c, p, s,
            _build.stream_handle(rois.device))
    _build.check(err, "roi_align_forward")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int | None = None,
                         max_span: tuple[float, float] | None = DEFAULT_MAX_SPAN,
                         ) -> torch.Tensor:
    """RoIAlign over an FPN: routes each RoI to a level, then runs kernel
    K2 on CUDA tensors or its plain version on CPU tensors.

    features: per-level ``[B, Hl, Wl, C]`` (NHWC), finest first; rois:
    ``[B, R, 4]`` image coordinates (padding rows give finite garbage).
    Returns ``[B, R, P, P, C]``.
    """
    num_levels = len(features)
    if min_level is None:
        min_level = int(np.log2(strides[0]))
    levels = assign_fpn_levels(rois, num_levels, min_level, max_span=max_span)
    if rois.is_cuda:
        return multilevel_roi_align_cuda(features, rois, levels, strides,
                                         output_size, sampling_ratio)
    return multilevel_roi_align_plain(features, rois, levels, strides,
                                      output_size, sampling_ratio)
