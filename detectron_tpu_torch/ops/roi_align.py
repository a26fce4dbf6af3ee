"""Multilevel RoIAlign over an FPN, forward and gradient, with FPN level
routing.

The port of ``detectron_tpu/ops/roi_align.py`` and of the RoIAlign custom
VJPs of ``detectron_tpu/ops/roi_align_pallas.py``: per-level NHWC features
``[B, Hl, Wl, C]`` and image-coordinate RoIs ``[B, R, 4]`` give pooled
features ``[B, R, P, P, C]``. Semantics are the JAX package's:
``sampling_ratio**2`` samples per bin averaged, the Caffe2 border rule (a
sample outside ``[-1, size]`` contributes 0, otherwise it is clamped to
``[0, size - 1]``), and with ``aligned=False`` (the default) an RoI extent
of at least one cell; ``aligned=True`` shifts the RoI by half a cell
(``x * scale - 0.5``) and drops the minimum extent (at least 0). The RoIs
get no gradient. :func:`roi_align` is the single-level function.

:func:`multilevel_roi_align` routes every RoI with :func:`assign_fpn_levels`
and then applies :class:`RoIAlignFunction`: on CUDA tensors the
hand-written kernels of ``csrc/roi_align.cu``, K2 forward and K3 backward
(the ports of ``multilevel_roi_align_pallas`` and
``multilevel_roi_align_pallas_bwd``); on CPU tensors their plain PyTorch
versions, :func:`multilevel_roi_align_plain` and
:func:`multilevel_roi_align_bwd_plain`. All four take the same level
index, so forward and backward route identically by construction.

Features may be float32 or bfloat16, as the JAX kernels take either: the
output (forward) and the level gradients (backward) come in the features'
dtype, every sum is float32, and a bf16 result is the float32 result on
the upcast inputs rounded once. The Pallas backward rounds each level's
gradient to bf16 after every RoI's window; the port rounds it once, after
all RoIs (a stated divergence, the more accurate of the two). On the card
the kernels take every input the plain versions take (any C, level
layout, ``output_size * sampling_ratio`` and level count: padding, a
copy, or the wide route's kernels); :func:`check_roi_align_contract`
refuses, when a detector is built, only a dtype without an instance.
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

    ``roi.pool_type=pool`` (RoIPool) routes with its window's span,
    ``(28, 36)`` (:func:`roi_pool_max_span` of the window 32 that the JAX
    model always gives it).
    ``roi.align_impl=window`` (the default) routes with the window's span,
    ``(win_h - 4, win_w - 4)``; ``align_impl=gather`` and
    ``model.fused_roi_align=on`` route with ``DEFAULT_MAX_SPAN``.
    ``fused_roi_align=auto`` means off, as it does on every backend but a
    TPU.
    """
    if cfg.roi.get("pool_type", "align") == "pool":
        # the JAX model passes RoIPool no window: 32, whatever roi.window says
        return roi_pool_max_span(ROI_POOL_WINDOW)
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
    # made on the device (a copy from the host would wait for it), in
    # float64 as the JAX package's numpy, then rounded once
    steps = torch.arange(pool, dtype=torch.float64, device=lo.device)
    frac = true_div(torch.arange(ratio, dtype=torch.float64, device=lo.device) + 0.5, ratio)
    pos = (steps[:, None] + frac[None, :]).reshape(-1).float()
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


def _sample_geometry(level_hw, rois, levels, strides, p: int, s: int,
                     aligned: bool = False):
    """Where the samples of every RoI fall in the concatenated levels.

    ``level_hw``: the ``(H, W)`` of each level; ``levels [B, R]``: the
    routing. Returns ``(base, wrow, ys, xs)``: ``base [B, R, 1, 1]`` the
    offset of each RoI's level in one image's flattened levels, ``wrow``
    its level's width, and per axis the ``(i0, i1, w0, w1, inb)`` of
    :func:`_bilinear_1d` over ``P * S`` samples.

    The frame rounds as the JAX package's does, step by step in float32:
    ``x1 = x * scale - shift`` and ``w = max(x2 * scale - shift - x1,
    1 or 0)``, where the shift (0.5 with ``aligned``) is subtracted only
    when it is not 0. The kernels round the same steps (``roi_frame``).
    """
    dev = rois.device
    hs = torch.tensor([h for h, _ in level_hw], device=dev)
    ws = torch.tensor([w for _, w in level_hw], device=dev)
    offsets = torch.cumsum(hs * ws, 0) - hs * ws
    strides_t = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    lvl = levels.long()
    scale = 1.0 / strides_t[lvl]  # [B, R]
    x1, y1, x2, y2 = (rois[..., i] * scale for i in range(4))
    if aligned:
        x1, y1, x2, y2 = x1 - 0.5, y1 - 0.5, x2 - 0.5, y2 - 0.5
    rw = (x2 - x1).clamp_min(0.0 if aligned else 1.0)
    rh = (y2 - y1).clamp_min(0.0 if aligned else 1.0)
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
                               output_size: int = 7, sampling_ratio: int = 2,
                               aligned: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel K2: a gather of the four bilinear
    corners of every sample from the concatenated levels, on any device.
    ``levels [B, R]`` is the routing of :func:`assign_fpn_levels`."""
    p, s = output_size, sampling_ratio
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)  # [B, L, C]
    base, wrow, ys, xs = _sample_geometry([f.shape[1:3] for f in features], rois,
                                          levels, strides, p, s, aligned)
    bidx = torch.arange(b, device=rois.device)[:, None, None, None]
    # the corners gathered in the features' dtype, summed in float32
    pts = sum(flat[bidx, idx].float() * w[..., None]  # [B, R, PS, PS, C]
              for idx, w in _corners(base, wrow, ys, xs))
    inb = (ys[4][..., :, None] & xs[4][..., None, :])[..., None]
    pts = torch.where(inb, pts, torch.zeros_like(pts))
    return pts.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5)).to(features[0].dtype)


def multilevel_roi_align_bwd_plain(grad: torch.Tensor, level_hw, rois: torch.Tensor,
                                   levels: torch.Tensor, strides: Sequence[int],
                                   sampling_ratio: int = 2,
                                   aligned: bool = False) -> list[torch.Tensor]:
    """Plain PyTorch version of kernel K3, the gradient of
    :func:`multilevel_roi_align_plain` with respect to each level:
    ``index_add_`` of every sample's weighted corner contributions,
    ``grad * wy * wx / S^2``, into the flattened levels.

    grad: ``[B, R, P, P, C]``; level_hw: the ``(H, W)`` of each level;
    levels: the routing the forward used. Returns per-level
    ``[B, Hl, Wl, C]`` gradients in ``grad``'s dtype: summed in float32
    from the upcast ``grad``, then rounded once.
    """
    b, r, p, _, c = grad.shape
    s = sampling_ratio
    sizes = [int(h) * int(w) for h, w in level_hw]
    total = sum(sizes)
    base, wrow, ys, xs = _sample_geometry(level_hw, rois, levels, strides, p, s, aligned)
    # d(mean over the S x S samples of a bin) = grad / S^2 at every sample
    gs = true_div(grad.float(), s * s)[:, :, :, None, :, None, :]
    gs = gs.expand(b, r, p, s, p, s, c).reshape(b, r, p * s, p * s, c)
    inb = (ys[4][..., :, None] & xs[4][..., None, :])[..., None]
    gs = torch.where(inb, gs, torch.zeros_like(gs))
    out = torch.zeros(b * total, c, dtype=torch.float32, device=grad.device)
    bbase = torch.arange(b, device=rois.device)[:, None, None, None] * total
    for idx, w in _corners(base, wrow, ys, xs):
        out.index_add_(0, (bbase + idx).reshape(-1), (gs * w[..., None]).reshape(-1, c))
    out = out.to(grad.dtype).view(b, total, c)
    offsets = np.cumsum([0] + sizes)
    return [out[:, o:o + n].reshape(b, int(h), int(w), c)
            for o, n, (h, w) in zip(offsets, sizes, level_hw)]


# The narrow instances of K2 and K3 (csrc/roi_align.cu: kMaxLevels,
# kMaxSamples, and what their shared memory holds) take at most this many
# levels and P * S samples along an axis; every other input goes through the
# wide route's kernels, which take any (roi_align_narrow says which).
MAX_LEVELS = 8
MAX_SAMPLES = 64
# The channel multiple of each dtype's instances (16-byte copies, float4
# atomics): the wrappers pad C up to it with zero channels.
CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}
# roi_align_narrow's kinds
K2_F32, K2_BF16, K3_F32, K3_BF16, K3_BOUNDS = range(5)


def check_roi_align_contract(cfg, dtype: torch.dtype) -> None:
    """Raises ``ValueError``, naming the config key, where ``cfg`` (computing
    in ``dtype``) asks kernels K2 and K3 for what they cannot run, so that a
    detector on the card fails when it is built and not in the middle of a
    call: a dtype without an instance (``model.dtype``: float32 and bfloat16
    have one, as the JAX config takes no other), or a pool size or sampling
    ratio below 1, which no RoIAlign computes. Every channel count, pool
    size, sampling ratio and level count runs on the card (the wide route
    past the narrow instances); no limit remains but the card's memory."""
    if dtype not in CHANNEL_MULTIPLE:
        raise ValueError(f"model.dtype: the RoIAlign kernels take float32 or bfloat16, "
                         f"not {dtype}")
    sizes = [("roi.pool_size", cfg.roi.pool_size), ("roi.sampling_ratio", cfg.roi.sampling_ratio)]
    if cfg.model.name == "mask_rcnn":
        sizes.append(("roi.mask_pool_size", cfg.roi.mask_pool_size))
    for key, size in sizes:
        if size < 1:
            raise ValueError(f"{key}={size}: RoIAlign needs at least 1")


@functools.cache
def _roi_align_lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geometry = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), i32]
    # the last int of each entry is `aligned` (0 or 1)
    for fn in (lib.roi_align_forward, lib.roi_align_forward_bf16, lib.roi_align_backward):
        fn.argtypes = [ctypes.POINTER(ptr), *geometry, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i32, ptr]
    lib.roi_tap_bounds.argtypes = [*geometry, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.roi_align_backward_tiles_bf16.argtypes = [
        ctypes.POINTER(ptr), *geometry, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.roi_align_forward_bf16_plan.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.roi_align_forward_bf16_plan.restype = None
    lib.roi_align_narrow.argtypes = [i32] * 5
    # the wide route: (table, levels), rois, routing, out or g, then as above, bf16, aligned
    for fn in (lib.roi_align_forward_wide, lib.roi_align_backward_wide):
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.roi_tap_bounds_wide.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.cast_bf16.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    for fn in (lib.roi_align_forward, lib.roi_align_forward_bf16, lib.roi_align_backward,
               lib.roi_tap_bounds, lib.roi_align_backward_tiles_bf16, lib.roi_align_narrow,
               lib.roi_align_forward_wide, lib.roi_align_backward_wide,
               lib.roi_tap_bounds_wide, lib.cast_bf16):
        fn.restype = ctypes.c_int
    return lib


def narrow_takes(kind: int, channels: int, p: int, s: int, num_levels: int) -> bool:
    """Whether the narrow instances of ``kind`` (``K2_F32`` .. ``K3_BOUNDS``)
    take ``channels`` (a multiple of the dtype's) at P and S over
    ``num_levels`` levels: at most :data:`MAX_LEVELS` levels and
    :data:`MAX_SAMPLES` samples an axis, and a channel slice whose shared
    memory fits (the library's ``roi_align_narrow``). Else the wide
    route."""
    if num_levels > MAX_LEVELS or p * s > MAX_SAMPLES:
        return False
    return bool(_roi_align_lib().roi_align_narrow(kind, channels, p, s, num_levels))


def kernel_ready(t: torch.Tensor, channels: int | None = None) -> torch.Tensor:
    """``t`` as the kernels read it: contiguous, 16-byte aligned and, with
    ``channels``, its last dimension padded to that many with zero
    channels. A tensor that is all that already is returned as it is; any
    other is copied once, into a fresh allocation (the caching allocator's
    are 512-byte aligned)."""
    if channels is not None and t.shape[-1] != channels:
        return torch.nn.functional.pad(t, (0, channels - t.shape[-1]))
    if not t.is_contiguous() or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def padded_channels(c: int, dtype: torch.dtype) -> int:
    """C rounded up to the channel multiple of ``dtype``'s instances."""
    multiple = CHANNEL_MULTIPLE[dtype]
    return -(-c // multiple) * multiple


def _launch_args(rois, levels, num_levels, strides, p, s):
    """Checks what K2 and K3 share (RoIs, routing, level count, sizes) and
    returns the RoIs and routing as the kernels read them: float32 RoIs,
    int32 routing, both contiguous and aligned."""
    if num_levels < 1 or len(strides) != num_levels:
        raise ValueError(f"{num_levels} levels and {len(strides)} strides: want as many "
                         "strides as levels, at least one")
    if not (rois.is_cuda and rois.is_floating_point() and rois.dim() == 3
            and rois.shape[2] == 4):
        raise ValueError("rois: a floating-point [B, R, 4] CUDA tensor")
    if not (levels.device == rois.device and levels.shape == rois.shape[:2]):
        raise ValueError("levels: a [B, R] tensor on the RoIs' device")
    if p < 1 or s < 1:
        raise ValueError(f"output_size={p}, sampling_ratio={s}: RoIAlign needs at least 1 of "
                         "each")
    return kernel_ready(rois.float()), kernel_ready(levels.to(torch.int32))


def _level_args(tensors, strides):
    n = len(tensors)
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * n)(*[t.shape[1] for t in tensors]),
            (ctypes.c_int * n)(*[t.shape[2] for t in tensors]),
            (ctypes.c_float * n)(*[float(x) for x in strides]), n)


def level_table(ptrs, level_hw, strides, device) -> torch.Tensor:
    """The wide route's level table in device memory: ``[4, n]`` int64 rows
    of level pointers, heights, widths and the strides' float32 bits, any
    ``n``. Filled in pinned host memory and copied without a host sync."""
    host = torch.empty((4, len(level_hw)), dtype=torch.int64, pin_memory=True)
    host[0] = torch.tensor([int(x) for x in ptrs], dtype=torch.int64)
    host[1] = torch.tensor([int(h) for h, _ in level_hw], dtype=torch.int64)
    host[2] = torch.tensor([int(w) for _, w in level_hw], dtype=torch.int64)
    host[3] = torch.tensor([float(x) for x in strides]).view(torch.int32).to(torch.int64)
    return host.to(device, non_blocking=True)


def _kernel_dtype(dtype: torch.dtype, what: str) -> int:
    """The channel multiple of the kernels' instance for ``dtype``."""
    if dtype not in CHANNEL_MULTIPLE:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16, not {dtype}")
    return CHANNEL_MULTIPLE[dtype]


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor], rois: torch.Tensor,
                              levels: torch.Tensor, strides: Sequence[int],
                              output_size: int = 7, sampling_ratio: int = 2,
                              aligned: bool = False) -> torch.Tensor:
    """:func:`multilevel_roi_align_plain` as kernel K2 of
    ``csrc/roi_align.cu``: one launch for all RoIs of all levels. A block
    folds its RoI's samples onto the cells they touch, stages those cells
    once per channel slice and contracts them along x, then y; bfloat16
    features (read as they are, summed in float32, written bf16) go
    through a persistent, warp-specialised kernel whose set-up and copies
    run beside its passes (:func:`k2_bf16_plan`). Deterministic (no
    atomics). ``aligned`` selects the kernels' aligned instances (the
    half-cell shift, no minimum extent).

    Takes every input the plain version takes, in float32 or bfloat16: a C
    that is not a multiple of 4 (bf16: 8) is padded with zero channels and
    the output sliced back; a level that is a view or misaligned is copied
    once (:func:`kernel_ready`); more than :data:`MAX_LEVELS` levels, more
    than :data:`MAX_SAMPLES` samples an axis, or sizes whose shared memory
    the narrow instances do not hold go through the wide route's kernel
    (:func:`narrow_takes`), which gives the same values."""
    p, s = output_size, sampling_ratio
    rois, levels = _launch_args(rois, levels, len(features), strides, p, s)
    f0 = features[0]
    b, r = rois.shape[:2]
    c = f0.shape[-1]
    _kernel_dtype(f0.dtype, "features")
    for f in features:
        if not (f.is_cuda and f.device == rois.device and f.dtype == f0.dtype
                and f.dim() == 4 and f.shape[0] == b and f.shape[3] == c):
            raise ValueError("features: NHWC CUDA tensors of one dtype on the RoIs' device, "
                             "one batch and channel count")
    if b * r == 0 or c == 0:
        return torch.empty((b, r, p, p, c), dtype=f0.dtype, device=rois.device)
    out = roi_align_forward_padded(features, rois, levels, strides, p, s, aligned)
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def roi_align_forward_padded(features, rois, levels, strides, p, s, aligned):
    """K2's one launch on checked inputs (RoIs and routing kernel-ready):
    the levels padded to the dtype's channel multiple and made kernel-ready,
    the route picked (:func:`narrow_takes`), then :func:`roi_align_fwd_launch`;
    the output sliced back to the features' C."""
    c = features[0].shape[-1]
    cp = padded_channels(c, features[0].dtype)
    feats = [kernel_ready(f, cp) for f in features]
    kind = K2_BF16 if feats[0].dtype == torch.bfloat16 else K2_F32
    narrow = narrow_takes(kind, cp, p, s, len(feats))
    out = roi_align_fwd_launch(narrow, feats, rois, levels, strides, p, s, aligned)
    return out if cp == c else out[..., :c]


def roi_align_fwd_launch(narrow: bool, features, rois, levels, strides, p, s,
                         aligned) -> torch.Tensor:
    """K2's launch alone, on kernel-ready inputs (C a multiple of the
    dtype's): the narrow instance of the features' dtype, or the wide
    route's kernel. Returns ``[B, R, P, P, C]``; counts nothing."""
    f0 = features[0]
    b, r = rois.shape[:2]
    c = f0.shape[-1]
    bf16 = f0.dtype == torch.bfloat16
    out = torch.empty((b, r, p, p, c), dtype=f0.dtype, device=rois.device)
    lib = _roi_align_lib()
    stream = _build.stream_handle(rois.device)
    with torch.cuda.device(rois.device):
        if narrow:
            fn = lib.roi_align_forward_bf16 if bf16 else lib.roi_align_forward
            err = fn(*_level_args(features, strides), rois.data_ptr(), levels.data_ptr(),
                     out.data_ptr(), b * r, r, c, p, s, int(aligned), stream)
        else:
            table = level_table([f.data_ptr() for f in features],
                                [f.shape[1:3] for f in features], strides, rois.device)
            err = lib.roi_align_forward_wide(table.data_ptr(), len(features), rois.data_ptr(),
                                             levels.data_ptr(), out.data_ptr(), b * r, r, c,
                                             p, s, int(bf16), int(aligned), stream)
    _build.check(err, "roi_align_forward" + ("" if narrow else "_wide"))
    return out


K2_BF16_PLAN = ("slice", "ring_rows", "stage_cells", "smem_bytes", "threads", "blocks_per_sm")


def k2_bf16_plan(channels: int, output_size: int, sampling_ratio: int) -> dict:
    """How K2's bf16 kernel runs ``channels`` channels at P and S (its C
    entry ``roi_align_forward_bf16_plan``): the channel slice of a work item
    (0: not this kernel, the wide route), the rows of its fp32 ring, the
    cells of a stage, a block's dynamic shared memory, its threads and the
    blocks an SM. Loads the kernel library."""
    plan = (ctypes.c_int * len(K2_BF16_PLAN))()
    _roi_align_lib().roi_align_forward_bf16_plan(channels, output_size, sampling_ratio, plan)
    return dict(zip(K2_BF16_PLAN, plan))


def multilevel_roi_align_bwd_cuda(grad: torch.Tensor, level_hw, rois: torch.Tensor,
                                  levels: torch.Tensor, strides: Sequence[int],
                                  sampling_ratio: int = 2,
                                  aligned: bool = False) -> list[torch.Tensor]:
    """:func:`multilevel_roi_align_bwd_plain` as kernel K3 of
    ``csrc/roi_align.cu``, by the route of ``grad``'s dtype.

    float32: one zero fill of all levels' float32 gradients, then one
    launch that builds each RoI's gradient window on chip and adds it into
    them, one 16-byte atomic add per touched cell and 4 channels (the order
    in which overlapping RoIs add, and so the last bits, varies from run to
    run).

    bfloat16: the pre-pass :func:`roi_tap_bounds_cuda` (each RoI's cell
    range of nonzero taps), then one launch, :func:`roi_align_bwd_tiles_cuda`,
    in which a block sums a tile of one level over the RoIs that meet it,
    in float32 and ascending order, and writes it to bf16 once: no fill, no
    atomics, no cast pass, and the result is bitwise deterministic.

    Takes every input the plain version takes, as K2 does: C padded to the
    dtype's multiple (each level gradient sliced back), a misaligned or
    non-contiguous ``grad`` copied once, and where the narrow instances do
    not take the sizes (:func:`narrow_takes`) the wide route: a zero fill,
    :func:`roi_align_bwd_wide_cuda` (every sample's corners added by
    16-byte atomics into float32 level gradients) and, for a bf16 ``grad``,
    :func:`cast_bf16_cuda` (each level rounded to bf16 once)."""
    s = sampling_ratio
    p = grad.shape[2] if grad.dim() == 5 else 0
    rois, levels = _launch_args(rois, levels, len(level_hw), strides, p, s)
    b, r = rois.shape[:2]
    if not (grad.is_cuda and grad.device == rois.device and grad.shape[:4] == (b, r, p, p)):
        raise ValueError("grad: a [B, R, P, P, C] CUDA tensor on the RoIs' device")
    _kernel_dtype(grad.dtype, "grad")
    grads, launched = roi_align_backward_padded(grad, level_hw, rois, levels, strides, s,
                                                aligned)
    if launched:
        multilevel_roi_align_bwd_cuda.launches += 1
    return grads


multilevel_roi_align_bwd_cuda.launches = 0


def roi_align_backward_padded(grad, level_hw, rois, levels, strides, s, aligned):
    """K3 on checked inputs (RoIs and routing kernel-ready): ``grad`` padded
    to the dtype's channel multiple and made kernel-ready, the route picked
    (:func:`narrow_takes`), its launches, and each level gradient sliced
    back to ``grad``'s C. Returns (the per-level gradients, whether K3
    launched)."""
    b, r, p, _, c = grad.shape
    cp = padded_channels(c, grad.dtype)
    g = kernel_ready(grad, cp)
    n = len(level_hw)
    launched = False
    if grad.dtype == torch.bfloat16:
        if not narrow_takes(K3_BF16, cp, p, s, n):
            flat = level_grad_buffer(b, cp, level_hw, rois.device)
            out = torch.empty(flat.shape, dtype=torch.bfloat16, device=rois.device)
            if b and cp:
                if r:
                    roi_align_bwd_wide_cuda(level_views(flat, b, cp, level_hw), g, rois,
                                            levels, strides, s, aligned)
                cast_bf16_cuda(flat, out)
                launched = True
        else:
            out = torch.empty(b * cp * sum(int(h) * int(w) for h, w in level_hw),
                              dtype=torch.bfloat16, device=rois.device)
            if b and cp:  # a tile that no RoI meets is written too: zeros
                bounds = roi_tap_bounds_cuda(level_hw, rois, levels, strides, p, s, aligned)
                roi_align_bwd_tiles_cuda(level_views(out, b, cp, level_hw), bounds, g, rois,
                                         levels, strides, s, aligned)
                launched = True
    else:
        out = level_grad_buffer(b, cp, level_hw, rois.device)
        if b * r and cp:
            accumulate = (roi_align_bwd_accumulate_cuda if narrow_takes(K3_F32, cp, p, s, n)
                          else roi_align_bwd_wide_cuda)
            accumulate(level_views(out, b, cp, level_hw), g, rois, levels, strides, s, aligned)
            launched = True
    grads = level_views(out, b, cp, level_hw)
    return (grads if cp == c else [x[..., :c] for x in grads]), launched


def level_views(flat: torch.Tensor, b: int, c: int, level_hw) -> list[torch.Tensor]:
    """``flat`` (all levels' gradients, one after another) viewed as the
    per-level ``[B, Hl, Wl, C]`` tensors."""
    sizes = [b * int(h) * int(w) * c for h, w in level_hw]
    return [part.view(b, int(h), int(w), c)
            for part, (h, w) in zip(flat.split(sizes), level_hw)]


def level_grad_buffer(b: int, c: int, level_hw, device) -> torch.Tensor:
    """K3's zero fill (the float32 route and the wide route): one zero fp32
    buffer for all levels' gradients (:func:`level_views` gives the
    per-level tensors)."""
    return torch.zeros(b * c * sum(int(h) * int(w) for h, w in level_hw), dtype=torch.float32,
                       device=device)


def roi_align_bwd_accumulate_cuda(grads: Sequence[torch.Tensor], grad: torch.Tensor,
                                  rois: torch.Tensor, levels: torch.Tensor,
                                  strides: Sequence[int], sampling_ratio: int = 2,
                                  aligned: bool = False) -> None:
    """K3's float32 launch alone: adds the gradient of every RoI into the
    float32 ``grads`` (:func:`level_views` of :func:`level_grad_buffer`).
    Takes what :func:`multilevel_roi_align_bwd_cuda` has checked and made
    kernel-ready, at sizes the narrow instance takes; counts nothing."""
    if grad.dtype != torch.float32:
        raise ValueError(f"roi_align_bwd_accumulate_cuda takes a float32 grad, not "
                         f"{grad.dtype}: a bfloat16 grad goes through "
                         "multilevel_roi_align_bwd_cuda (roi_tap_bounds_cuda, then "
                         "roi_align_bwd_tiles_cuda)")
    b, r = rois.shape[:2]
    p, c = grad.shape[2], grad.shape[4]
    with torch.cuda.device(rois.device):
        err = _roi_align_lib().roi_align_backward(
            *_level_args(grads, strides), rois.data_ptr(), levels.data_ptr(), grad.data_ptr(),
            b * r, r, c, p, sampling_ratio, int(aligned), _build.stream_handle(rois.device))
    _build.check(err, "roi_align_backward")


def roi_align_bwd_wide_cuda(grads: Sequence[torch.Tensor], grad: torch.Tensor,
                            rois: torch.Tensor, levels: torch.Tensor, strides: Sequence[int],
                            sampling_ratio: int = 2, aligned: bool = False) -> None:
    """K3's wide-route launch alone: adds every sample's four corner
    contributions of ``grad`` (float32 or bf16) into the float32 ``grads``
    (:func:`level_views` of :func:`level_grad_buffer`), by 16-byte atomics.
    Any level count and P * S; takes what :func:`multilevel_roi_align_bwd_cuda`
    has checked and made kernel-ready; counts nothing."""
    b, r = rois.shape[:2]
    p, c = grad.shape[2], grad.shape[4]
    with torch.cuda.device(rois.device):
        table = level_table([t.data_ptr() for t in grads], [t.shape[1:3] for t in grads],
                            strides, rois.device)
        err = _roi_align_lib().roi_align_backward_wide(
            table.data_ptr(), len(grads), rois.data_ptr(), levels.data_ptr(), grad.data_ptr(),
            b * r, r, c, p, sampling_ratio, int(grad.dtype == torch.bfloat16), int(aligned),
            _build.stream_handle(rois.device))
    _build.check(err, "roi_align_backward_wide")


def cast_bf16_cuda(src: torch.Tensor, dst: torch.Tensor) -> None:
    """The wide route's last launch for a bf16 ``grad``: ``dst`` (bf16) =
    ``src`` (float32, as many values, a multiple of 4) rounded to nearest
    even, as ``.to(torch.bfloat16)``: each level gradient rounded once.
    Counts nothing."""
    with torch.cuda.device(src.device):
        err = _roi_align_lib().cast_bf16(src.data_ptr(), dst.data_ptr(), src.numel(),
                                         _build.stream_handle(src.device))
    _build.check(err, "cast_bf16")


def roi_tap_cell_bounds(level_hw, rois: torch.Tensor, levels: torch.Tensor,
                        strides: Sequence[int], p: int, s: int = 2,
                        aligned: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3's bf16 pre-pass: per RoI, the first and
    last cell of its level that its nonzero taps touch along x and along y,
    ``[B, R, 4]`` int32 ``(x first, x last, y first, y last)``, an axis
    without a nonzero tap ``(0, -1)``. A tap is nonzero where its sample
    lies in ``[-1, size]`` and its bilinear weight is not 0: with the border
    rule's clamp, a sample just outside the level still touches its edge
    cell, so the range comes from the taps, not from the box."""
    _, _, ys, xs = _sample_geometry(level_hw, rois, levels, strides, p, s, aligned)
    out = []
    for i0, i1, w0, w1, inb in (xs, ys):
        tap0, tap1 = inb & (w0 != 0), inb & (w1 != 0)
        none = torch.iinfo(torch.int64).max
        first = torch.minimum(torch.where(tap0, i0, none).amin(-1),
                              torch.where(tap1, i1, none).amin(-1))
        last = torch.maximum(torch.where(tap0, i0, -1).amax(-1),
                             torch.where(tap1, i1, -1).amax(-1))
        out += [torch.where(last < 0, 0, first), last]
    return torch.stack(out, -1).to(torch.int32)


def roi_tap_bounds_cuda(level_hw, rois: torch.Tensor, levels: torch.Tensor,
                        strides: Sequence[int], p: int, s: int = 2,
                        aligned: bool = False) -> torch.Tensor:
    """:func:`roi_tap_cell_bounds` as K3's bf16 pre-pass
    (``csrc/roi_align.cu::roi_tap_bounds``): one warp a RoI runs the fold
    that K2 and K3 share and keeps its first and last cell; past the narrow
    instance's levels or samples, the wide route's pre-pass (a min and a
    max over the warp's samples). Also the library's entry for checking the
    pre-pass alone; counts nothing."""
    rois, levels = _launch_args(rois, levels, len(level_hw), strides, p, s)
    b, r = rois.shape[:2]
    n = len(level_hw)
    bounds = torch.empty((b, r, 4), dtype=torch.int32, device=rois.device)
    if b * r:
        lib = _roi_align_lib()
        stream = _build.stream_handle(rois.device)
        with torch.cuda.device(rois.device):
            if narrow_takes(K3_BOUNDS, 8, p, s, n):
                err = lib.roi_tap_bounds(
                    (ctypes.c_int * n)(*[int(h) for h, _ in level_hw]),
                    (ctypes.c_int * n)(*[int(w) for _, w in level_hw]),
                    (ctypes.c_float * n)(*[float(x) for x in strides]), n, rois.data_ptr(),
                    levels.data_ptr(), bounds.data_ptr(), b * r, p, s, int(aligned), stream)
            else:
                table = level_table([0] * n, level_hw, strides, rois.device)
                err = lib.roi_tap_bounds_wide(table.data_ptr(), n, rois.data_ptr(),
                                              levels.data_ptr(), bounds.data_ptr(), b * r, p, s,
                                              int(aligned), stream)
        _build.check(err, "roi_tap_bounds")
    return bounds


def roi_align_bwd_tiles_cuda(grads: Sequence[torch.Tensor], bounds: torch.Tensor,
                             grad: torch.Tensor, rois: torch.Tensor, levels: torch.Tensor,
                             strides: Sequence[int], sampling_ratio: int = 2,
                             aligned: bool = False) -> None:
    """K3's bf16 launch alone: writes every cell of the bf16 ``grads``
    (:func:`level_views` of one buffer; not filled), given the pre-pass's
    ``bounds``. Takes what :func:`multilevel_roi_align_bwd_cuda` has
    checked and made kernel-ready, at sizes the narrow instance takes;
    counts nothing."""
    if not (grad.is_cuda and bounds.is_cuda and all(x.is_cuda for x in grads)):
        raise ValueError("roi_align_bwd_tiles_cuda: grads, bounds and grad must be CUDA "
                         "tensors")
    b, r = rois.shape[:2]
    p, c = grad.shape[2], grad.shape[4]
    with torch.cuda.device(rois.device):
        err = _roi_align_lib().roi_align_backward_tiles_bf16(
            *_level_args(grads, strides), rois.data_ptr(), levels.data_ptr(),
            bounds.data_ptr(), grad.data_ptr(), b, r, c, p, sampling_ratio, int(aligned),
            _build.stream_handle(rois.device))
    _build.check(err, "roi_align_backward_tiles_bf16")


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign with its gradient: K2 forward and K3 backward on
    CUDA tensors, their plain versions on CPU tensors.

    ``apply(rois, levels, strides, output_size, sampling_ratio, aligned,
    *features)``.
    The backward takes the routing ``levels`` that the forward used, so the
    two route identically by construction, and it needs only the levels'
    shapes, not their values. The RoIs get no gradient (``None``), as the
    JAX package's custom VJPs give them zeros.
    """

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, sampling_ratio, aligned, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio, ctx.aligned = tuple(strides), sampling_ratio, aligned
        ctx.level_hw = [tuple(f.shape[1:3]) for f in features]
        fwd = multilevel_roi_align_cuda if rois.is_cuda else multilevel_roi_align_plain
        return fwd(features, rois, levels, strides, output_size, sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        bwd = (multilevel_roi_align_bwd_cuda if rois.is_cuda
               else multilevel_roi_align_bwd_plain)
        grads = bwd(grad.contiguous(), ctx.level_hw, rois, levels, ctx.strides,
                    ctx.sampling_ratio, ctx.aligned)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad[6:])]
        return (None,) * 6 + tuple(grads)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], output_size: int = 7,
                         sampling_ratio: int = 2, min_level: int | None = None,
                         canonical_level: int = 4, canonical_scale: float = 224.0,
                         aligned: bool = False,
                         max_span: tuple[float, float] | None = DEFAULT_MAX_SPAN,
                         ) -> torch.Tensor:
    """RoIAlign over an FPN: routes each RoI to a level
    (:func:`assign_fpn_levels` with ``canonical_level`` and
    ``canonical_scale``), then runs :class:`RoIAlignFunction` (kernels K2
    and K3 on CUDA tensors, their plain versions on CPU tensors),
    differentiable in the features. ``aligned``: see the module.

    features: per-level ``[B, Hl, Wl, C]`` (NHWC), finest first; rois:
    ``[B, R, 4]`` image coordinates (padding rows give finite garbage).
    Returns ``[B, R, P, P, C]``.
    """
    num_levels = len(features)
    if min_level is None:
        min_level = int(np.log2(strides[0]))
    levels = assign_fpn_levels(rois, num_levels, min_level, canonical_level, canonical_scale,
                               max_span=max_span)
    return RoIAlignFunction.apply(rois, levels, tuple(strides), output_size,
                                  sampling_ratio, bool(aligned), *features)


def roi_align(feature: torch.Tensor, rois: torch.Tensor, stride: int, output_size: int = 7,
              sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """Single-level RoIAlign (``detectron_tpu/ops/roi_align.py::roi_align``):
    :func:`multilevel_roi_align` over one level, differentiable in
    ``feature``. feature ``[B, H, W, C]``, rois ``[B, R, 4]`` -> ``[B, R,
    P, P, C]``. On CUDA tensors it runs K2 forward and K3 backward, which
    take what the plain versions take, in float32 or bfloat16 (any C, any
    layout of ``feature``, any ``output_size * sampling_ratio``); on CPU
    tensors it runs the plain versions."""
    return multilevel_roi_align([feature], rois, [stride], output_size=output_size,
                                sampling_ratio=sampling_ratio, aligned=aligned)


# ----------------------------------------------------------------- RoIPool

# The window of the JAX package's RoIPool (``multilevel_roi_pool(window=)``):
# the JAX model never passes another.
ROI_POOL_WINDOW = 32


def roi_pool_max_span(window: int = ROI_POOL_WINDOW) -> tuple[float, float]:
    """RoIPool's routing span, ``(window - 4, window + 4)`` cells."""
    return float(window - 4), float(window + 4)


def _pool_bins(start, extent, origin, win: int, limit, pool: int):
    """Per RoI and bin along one axis, the cells ``[a, b)`` of RoIPool's
    dynamic bin: ``[floor(p * e / pool), ceil((p + 1) * e / pool))`` from the
    quantized start, clipped to the level ``[0, limit)`` and to the window
    ``[origin, origin + win)`` (``detectron_tpu/ops/roi_align.py::
    _pool_bin_masks``: its membership mask is this range). Returns ``(a, b)``,
    int64 ``[..., pool]``; a bin is empty where ``b <= a``."""
    bin_size = true_div(extent, pool)[..., None]
    p = torch.arange(pool, dtype=torch.float32, device=start.device)
    lo = torch.floor(p * bin_size).to(torch.int64) + start[..., None]
    hi = torch.ceil((p + 1.0) * bin_size).to(torch.int64) + start[..., None]
    lim = limit[..., None]
    lo = torch.minimum(lo.clamp_min(0), lim)
    hi = torch.minimum(hi.clamp_min(0), lim)
    org = origin[..., None]
    return torch.maximum(lo, org), torch.minimum(hi, org + win)


def _floor_log2(n: torch.Tensor, k_max: int) -> torch.Tensor:
    """``floor(log2(n))`` of positive int64 ``n``, at most ``k_max``."""
    k = torch.zeros_like(n)
    for j in range(1, k_max + 1):
        k = k + (n >= (1 << j)).to(n.dtype)
    return k


def _range_max_tables(level: torch.Tensor, ky: int, kx: int) -> list[torch.Tensor]:
    """The sparse tables of one level ``[B, H, W, C]``: entry ``(i, j)`` of
    the list (``i * (kx + 1) + j``) holds at ``(y, x)`` the max over rows
    ``[y, y + 2^i)`` and columns ``[x, x + 2^j)`` (past the level's edge the
    last row or column repeats; no query reads there)."""
    def doubled(t, k, dim):
        n = t.shape[dim]
        idx = (torch.arange(n, device=t.device) + (1 << (k - 1))).clamp_max(n - 1)
        return torch.maximum(t, t.index_select(dim, idx))

    rows = [level]
    for i in range(1, ky + 1):
        rows.append(doubled(rows[-1], i, 1))
    tables = []
    for row in rows:
        tables.append(row)
        for j in range(1, kx + 1):
            tables.append(doubled(tables[-1], j, 2))
    return tables


def multilevel_roi_pool(features: Sequence[torch.Tensor], rois: torch.Tensor,
                        strides: Sequence[int], output_size: int = 7,
                        min_level: int | None = None,
                        window: int = ROI_POOL_WINDOW) -> torch.Tensor:
    """Exact dynamic-bin max RoIPool over an FPN: the port of
    ``detectron_tpu/ops/roi_align.py::multilevel_roi_pool``, bit for bit.

    Each RoI is routed with the span ``(window - 4, window + 4)``, quantized
    with ``round`` (half to even, as ``jnp.round``) at its level, given an
    extent of ``end - start + 1`` cells (at least 1), and bin ``(i, j)``
    takes the max over cells ``[floor(i * h / P), ceil((i + 1) * h / P))``
    x the same along x, clipped to the level and to the RoI's window
    (``window`` x ``window + 8`` cells, grown to hold the coarsest level
    whole, placed at the RoI's start and kept inside the level); a bin
    whose window holds none of its cells is 0.

    Where the JAX function gathers every RoI's whole window (``[R, 32, 40,
    C]`` an image), this one answers each bin from sparse tables of each
    level (the max over every ``2^i x 2^j`` block): the max over four
    overlapping blocks that cover the bin exactly. A level's table sizes
    follow from the routing (a RoI routed below the coarsest level spans
    at most ``span + 2`` cells there; at the coarsest, at most the level),
    so they do not depend on the data. Max is exact, so the values are the
    JAX function's; the gradient (autograd) goes to each bin's max cell,
    split evenly among equal maxima as under ``jax.grad``.

    features: per-level ``[B, Hl, Wl, C]`` (NHWC), finest first; rois
    ``[B, R, 4]`` image coordinates. Returns ``[B, R, P, P, C]`` in the
    features' dtype.
    """
    num_levels = len(features)
    if min_level is None:
        min_level = int(np.log2(strides[0]))
    pool = output_size
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dev = rois.device
    hs = [int(f.shape[1]) for f in features]
    ws = [int(f.shape[2]) for f in features]
    span = roi_pool_max_span(window)
    win_h, win_w = max(window, hs[-1]), max(window + 8, ws[-1])
    levels = assign_fpn_levels(rois, num_levels, min_level, max_span=span).long()

    # the largest bin each level can hold, along each axis, and its tables
    tables, ks = [], []
    for i, f in enumerate(features):
        if i == num_levels - 1:
            ny, nx = hs[i], ws[i]
        else:
            ny = min(int((span[0] + 2) // pool) + 2, hs[i], win_h)
            nx = min(int((span[1] + 2) // pool) + 2, ws[i], win_w)
        ky, kx = int(np.log2(max(ny, 1))), int(np.log2(max(nx, 1)))
        ks.append((ky, kx))
        tables.extend(t.reshape(b, -1, c) for t in _range_max_tables(f, ky, kx))
    flat = torch.cat(tables, dim=1)  # [B, sum of tables, C]
    k_max = max(max(k) for k in ks)
    # offset of table (ky, kx) of level l in ``flat``
    offsets = np.zeros((num_levels, k_max + 1, k_max + 1), np.int64)
    at = 0
    for i, (ky, kx) in enumerate(ks):
        for y in range(ky + 1):
            for x in range(kx + 1):
                offsets[i, y, x] = at
                at += hs[i] * ws[i]

    strides_t = torch.tensor([float(s) for s in strides], device=dev)
    hl = torch.tensor(hs, device=dev)[levels]
    wl = torch.tensor(ws, device=dev)[levels]
    scale = 1.0 / strides_t[levels]
    sx, sy, ex, ey = (torch.round(rois[..., i] * scale).to(torch.int64) for i in range(4))
    rw = (ex - sx + 1).clamp_min(1).float()
    rh = (ey - sy + 1).clamp_min(1).float()
    y0 = torch.minimum(sy.clamp_min(0), (hl - win_h).clamp_min(0))
    x0 = torch.minimum(sx.clamp_min(0), (wl - win_w).clamp_min(0))
    ya, yb = _pool_bins(sy, rh, y0, win_h, hl, pool)  # [B, R, P]
    xa, xb = _pool_bins(sx, rw, x0, win_w, wl, pool)
    ney, nex = yb > ya, xb > xa
    nonempty = (ney[..., :, None] & nex[..., None, :])[..., None]
    # empty bins read cell (0, 0) of their level; their output is 0
    ya, yb = torch.where(ney, ya, 0), torch.where(ney, yb, 1)
    xa, xb = torch.where(nex, xa, 0), torch.where(nex, xb, 1)
    lvl_k = torch.tensor(ks, device=dev)[levels]  # [B, R, 2]
    ky = _floor_log2(yb - ya, k_max).minimum(lvl_k[..., 0:1])
    kx = _floor_log2(xb - xa, k_max).minimum(lvl_k[..., 1:2])
    off = torch.as_tensor(offsets, device=dev)[levels[..., None, None], ky[..., :, None],
                                                 kx[..., None, :]]  # [B, R, P, P]
    wrow = wl[..., None, None]
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    corners = [flat[bidx, off + yy[..., :, None] * wrow + xx[..., None, :]]
               for yy in (ya, yb - (1 << ky)) for xx in (xa, xb - (1 << kx))]
    out = torch.stack(corners).amax(dim=0)  # [B, R, P, P, C]
    return torch.where(nonempty, out, torch.zeros_like(out))


def roi_pool(feature: torch.Tensor, rois: torch.Tensor, stride: int, output_size: int = 7,
             window: int = ROI_POOL_WINDOW) -> torch.Tensor:
    """Single-level exact dynamic-bin max RoIPool
    (``detectron_tpu/ops/roi_align.py::roi_pool``): :func:`multilevel_roi_pool`
    over one level."""
    return multilevel_roi_pool([feature], rois, [stride], output_size=output_size,
                               window=window)
