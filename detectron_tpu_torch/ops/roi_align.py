"""Multilevel RoIAlign over an FPN, forward and gradient, with FPN level
routing.

The port of ``detectron_tpu/ops/roi_align.py`` and of the RoIAlign custom
VJPs of ``detectron_tpu/ops/roi_align_pallas.py``: per-level NHWC features
``[B, Hl, Wl, C]`` and image-coordinate RoIs ``[B, R, 4]`` give pooled
features ``[B, R, P, P, C]``. Semantics are the JAX package's:
``aligned=False``, RoI extent at least one cell, ``sampling_ratio**2``
samples per bin averaged, and the Caffe2 border rule (a sample outside
``[-1, size]`` contributes 0, otherwise it is clamped to ``[0, size - 1]``).
The RoIs get no gradient.

:func:`multilevel_roi_align` routes every RoI with :func:`assign_fpn_levels`
and then applies :class:`RoIAlignFunction`: on CUDA tensors the
hand-written kernels of ``csrc/roi_align.cu``, K2 forward and K3 backward
(the ports of ``multilevel_roi_align_pallas`` and
``multilevel_roi_align_pallas_bwd``); on CPU tensors their plain PyTorch
versions, :func:`multilevel_roi_align_plain` and
:func:`multilevel_roi_align_bwd_plain`. All four take the same level
index, so forward and backward route identically by construction.
"""

from __future__ import annotations

import ctypes
import functools
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


def _sample_geometry(level_hw, rois, levels, strides, p: int, s: int):
    """Where the samples of every RoI fall in the concatenated levels.

    ``level_hw``: the ``(H, W)`` of each level; ``levels [B, R]``: the
    routing. Returns ``(base, wrow, ys, xs)``: ``base [B, R, 1, 1]`` the
    offset of each RoI's level in one image's flattened levels, ``wrow``
    its level's width, and per axis the ``(i0, i1, w0, w1, inb)`` of
    :func:`_bilinear_1d` over ``P * S`` samples.
    """
    dev = rois.device
    hs = torch.tensor([h for h, _ in level_hw], device=dev)
    ws = torch.tensor([w for _, w in level_hw], device=dev)
    offsets = torch.cumsum(hs * ws, 0) - hs * ws
    strides_t = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    lvl = levels.long()
    scale = 1.0 / strides_t[lvl]  # [B, R]
    x1 = rois[..., 0] * scale
    y1 = rois[..., 1] * scale
    rw = (rois[..., 2] * scale - x1).clamp_min(1.0)
    rh = (rois[..., 3] * scale - y1).clamp_min(1.0)
    xs = _bilinear_1d(_sample_coords(x1, rw, p, s), ws[lvl].float()[..., None])
    ys = _bilinear_1d(_sample_coords(y1, rh, p, s), hs[lvl].float()[..., None])
    return offsets[lvl][..., None, None], ws[lvl][..., None, None], ys, xs


def _corners(base, wrow, ys, xs):
    """The four bilinear corners of every sample: ``(flat index
    [B, R, PS, PS], weight [B, R, PS, PS])`` each."""
    y0, y1, wy0, wy1, _ = ys
    x0, x1, wx0, wx1, _ = xs
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            yield (base + yi[..., :, None] * wrow + xi[..., None, :],
                   wy[..., :, None] * wx[..., None, :])


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
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)  # [B, L, C]
    base, wrow, ys, xs = _sample_geometry([f.shape[1:3] for f in features], rois,
                                          levels, strides, p, s)
    bidx = torch.arange(b, device=rois.device)[:, None, None, None]
    pts = sum(flat[bidx, idx] * w[..., None]  # [B, R, PS, PS, C]
              for idx, w in _corners(base, wrow, ys, xs))
    inb = (ys[4][..., :, None] & xs[4][..., None, :])[..., None]
    pts = torch.where(inb, pts, torch.zeros_like(pts))
    return pts.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))


def multilevel_roi_align_bwd_plain(grad: torch.Tensor, level_hw, rois: torch.Tensor,
                                   levels: torch.Tensor, strides: Sequence[int],
                                   sampling_ratio: int = 2) -> list[torch.Tensor]:
    """Plain PyTorch version of kernel K3, the gradient of
    :func:`multilevel_roi_align_plain` with respect to each level:
    ``index_add_`` of every sample's weighted corner contributions,
    ``grad * wy * wx / S^2``, into the flattened levels.

    grad: ``[B, R, P, P, C]``; level_hw: the ``(H, W)`` of each level;
    levels: the routing the forward used. Returns per-level
    ``[B, Hl, Wl, C]`` gradients in ``grad``'s dtype.
    """
    b, r, p, _, c = grad.shape
    s = sampling_ratio
    sizes = [int(h) * int(w) for h, w in level_hw]
    total = sum(sizes)
    base, wrow, ys, xs = _sample_geometry(level_hw, rois, levels, strides, p, s)
    # d(mean over the S x S samples of a bin) = grad / S^2 at every sample
    gs = true_div(grad, s * s)[:, :, :, None, :, None, :]
    gs = gs.expand(b, r, p, s, p, s, c).reshape(b, r, p * s, p * s, c)
    inb = (ys[4][..., :, None] & xs[4][..., None, :])[..., None]
    gs = torch.where(inb, gs, torch.zeros_like(gs))
    out = grad.new_zeros(b * total, c)
    bbase = torch.arange(b, device=rois.device)[:, None, None, None] * total
    for idx, w in _corners(base, wrow, ys, xs):
        out.index_add_(0, (bbase + idx).reshape(-1), (gs * w[..., None]).reshape(-1, c))
    out = out.view(b, total, c)
    offsets = np.cumsum([0] + sizes)
    return [out[:, o:o + n].reshape(b, int(h), int(w), c)
            for o, n, (h, w) in zip(offsets, sizes, level_hw)]


_MAX_LEVELS = 8


@functools.cache
def _roi_align_lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    for fn in (lib.roi_align_forward, lib.roi_align_backward):
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_launch_args(rois, levels, num_levels, strides, p, s):
    """Checks what K2 and K3 share: RoIs, routing, level count, sizes."""
    if not 1 <= num_levels <= _MAX_LEVELS or len(strides) != num_levels:
        raise ValueError(f"{num_levels} levels and {len(strides)} strides: "
                         f"want 1..{_MAX_LEVELS} of each")
    if not (rois.is_cuda and rois.dtype == torch.float32 and rois.dim() == 3
            and rois.shape[2] == 4 and rois.is_contiguous()
            and rois.data_ptr() % 16 == 0):
        raise ValueError("rois: a contiguous, 16-byte aligned float32 [B, R, 4] "
                         "CUDA tensor")
    if not (levels.device == rois.device and levels.dtype == torch.int32
            and levels.shape == rois.shape[:2] and levels.is_contiguous()):
        raise ValueError("levels: a contiguous int32 [B, R] tensor on the RoIs' "
                         "device")
    if p * s > 64 or p < 1 or s < 1:
        raise ValueError(f"output_size * sampling_ratio = {p * s}: the kernel "
                         "takes 1..64 samples per axis")


def _level_args(tensors, strides):
    n = len(tensors)
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * n)(*[t.shape[1] for t in tensors]),
            (ctypes.c_int * n)(*[t.shape[2] for t in tensors]),
            (ctypes.c_float * n)(*[float(x) for x in strides]), n)


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor], rois: torch.Tensor,
                              levels: torch.Tensor, strides: Sequence[int],
                              output_size: int = 7,
                              sampling_ratio: int = 2) -> torch.Tensor:
    """:func:`multilevel_roi_align_plain` as kernel K2 of
    ``csrc/roi_align.cu``: one launch for all RoIs of all levels. A block
    folds its RoI's samples onto the cells they touch, stages those cells
    once per channel slice and contracts them along x, then y.
    Deterministic (no atomics). Takes C a multiple of 4 and 16-byte aligned
    levels."""
    f0 = features[0]
    if f0.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bfloat16 RoIAlign kernel is not ported yet: ROADMAP.md, Queue 2, "
            "bf16 kernels")
    p, s = output_size, sampling_ratio
    _check_launch_args(rois, levels, len(features), strides, p, s)
    b, r = rois.shape[:2]
    c = f0.shape[-1]
    for f in features:
        if not (f.is_cuda and f.device == rois.device and f.dtype == torch.float32
                and f.dim() == 4 and f.shape[0] == b and f.shape[3] == c
                and f.is_contiguous()):
            raise ValueError("features: contiguous float32 NHWC CUDA tensors on "
                             "the RoIs' device, one batch and channel count")
    if c % 4 or any(f.data_ptr() % 16 for f in features):
        # so that every cell's slice is whole float4s, copied 16 bytes at a time
        raise ValueError(f"features: K2 copies 4 channels at a time and takes C a multiple "
                         f"of 4 (C={c}) and 16-byte aligned levels")
    out = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    if b * r == 0 or c == 0:
        return out
    lib = _roi_align_lib()
    with torch.cuda.device(rois.device):
        err = lib.roi_align_forward(
            *_level_args(features, strides), rois.data_ptr(), levels.data_ptr(),
            out.data_ptr(), b * r, r, c, p, s, _build.stream_handle(rois.device))
    _build.check(err, "roi_align_forward")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def multilevel_roi_align_bwd_cuda(grad: torch.Tensor, level_hw, rois: torch.Tensor,
                                  levels: torch.Tensor, strides: Sequence[int],
                                  sampling_ratio: int = 2) -> list[torch.Tensor]:
    """:func:`multilevel_roi_align_bwd_plain` as kernel K3 of
    ``csrc/roi_align.cu``: one zero fill of all levels' gradients, then one
    launch that builds each RoI's gradient window on chip and adds it into
    them, one 16-byte atomic add per touched cell and 4 channels (the order
    in which overlapping RoIs add, and so the last bits, varies from run to
    run). Takes C a multiple of 4 and a 16-byte aligned ``grad``."""
    if grad.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bfloat16 RoIAlign kernel is not ported yet: ROADMAP.md, Queue 2, "
            "bf16 kernels")
    s = sampling_ratio
    p = grad.shape[2] if grad.dim() == 5 else 0
    _check_launch_args(rois, levels, len(level_hw), strides, p, s)
    b, r = rois.shape[:2]
    if not (grad.is_cuda and grad.device == rois.device and grad.dtype == torch.float32
            and grad.shape[:4] == (b, r, p, p) and grad.is_contiguous()):
        raise ValueError("grad: a contiguous float32 [B, R, P, P, C] CUDA tensor on "
                         "the RoIs' device")
    if grad.shape[4] % 4 or grad.data_ptr() % 16:
        # so that every cell of grad and of the level gradients is float4-aligned
        raise ValueError(f"grad: K3 adds 4 channels at a time and takes C a multiple of "
                         f"4 (C={grad.shape[4]}) and a 16-byte aligned tensor")
    grads = level_grad_buffers(b, grad.shape[4], level_hw, rois.device)
    if b * r == 0 or grad.shape[4] == 0:
        return grads
    roi_align_bwd_accumulate_cuda(grads, grad, rois, levels, strides, s)
    multilevel_roi_align_bwd_cuda.launches += 1
    return grads


multilevel_roi_align_bwd_cuda.launches = 0


def level_grad_buffers(b: int, c: int, level_hw, device) -> list[torch.Tensor]:
    """K3's zero fill: one zero fp32 buffer for all levels' gradients,
    viewed as per-level ``[B, Hl, Wl, C]`` tensors."""
    sizes = [b * int(h) * int(w) * c for h, w in level_hw]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
    return [part.view(b, int(h), int(w), c)
            for part, (h, w) in zip(flat.split(sizes), level_hw)]


def roi_align_bwd_accumulate_cuda(grads: Sequence[torch.Tensor], grad: torch.Tensor,
                                  rois: torch.Tensor, levels: torch.Tensor,
                                  strides: Sequence[int], sampling_ratio: int = 2) -> None:
    """K3's launch alone: adds the gradient of every RoI into ``grads``
    (:func:`level_grad_buffers`). Takes what
    :func:`multilevel_roi_align_bwd_cuda` has checked; counts nothing."""
    b, r = rois.shape[:2]
    p, c = grad.shape[2], grad.shape[4]
    with torch.cuda.device(rois.device):
        err = _roi_align_lib().roi_align_backward(
            *_level_args(grads, strides), rois.data_ptr(), levels.data_ptr(),
            grad.data_ptr(), b * r, r, c, p, sampling_ratio,
            _build.stream_handle(rois.device))
    _build.check(err, "roi_align_backward")


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign with its gradient: K2 forward and K3 backward on
    CUDA tensors, their plain versions on CPU tensors.

    ``apply(rois, levels, strides, output_size, sampling_ratio, *features)``.
    The backward takes the routing ``levels`` that the forward used, so the
    two route identically by construction, and it needs only the levels'
    shapes, not their values. The RoIs get no gradient (``None``), as the
    JAX package's custom VJPs give them zeros.
    """

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, sampling_ratio, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio = tuple(strides), sampling_ratio
        ctx.level_hw = [tuple(f.shape[1:3]) for f in features]
        fwd = multilevel_roi_align_cuda if rois.is_cuda else multilevel_roi_align_plain
        return fwd(features, rois, levels, strides, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        bwd = (multilevel_roi_align_bwd_cuda if rois.is_cuda
               else multilevel_roi_align_bwd_plain)
        grads = bwd(grad.contiguous(), ctx.level_hw, rois, levels, ctx.strides,
                    ctx.sampling_ratio)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad[5:])]
        return (None, None, None, None, None, *grads)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int | None = None,
                         max_span: tuple[float, float] | None = DEFAULT_MAX_SPAN,
                         ) -> torch.Tensor:
    """RoIAlign over an FPN: routes each RoI to a level, then runs
    :class:`RoIAlignFunction` (kernels K2 and K3 on CUDA tensors, their
    plain versions on CPU tensors), differentiable in the features.

    features: per-level ``[B, Hl, Wl, C]`` (NHWC), finest first; rois:
    ``[B, R, 4]`` image coordinates (padding rows give finite garbage).
    Returns ``[B, R, P, P, C]``.
    """
    num_levels = len(features)
    if min_level is None:
        min_level = int(np.log2(strides[0]))
    levels = assign_fpn_levels(rois, num_levels, min_level, max_span=max_span)
    return RoIAlignFunction.apply(rois, levels, tuple(strides), output_size,
                                  sampling_ratio, *features)
