"""A convolution's epilogue as one pass at inference: the bias, the FPN's
2x nearest top-down add and the ReLU.

``y = relu?(x + bias [+ up2(coarse)])`` over NCHW-shaped tensors, where
``up2(coarse)`` reads the coarser level at ``(h // 2, w // 2)``: what
``F.interpolate(coarse, scale_factor=2, mode="nearest")`` would write, never
written. Every op is rounded to the tensor's dtype as the eager chain rounds
it (first ``x + bias``, then the coarse add, the ReLU last), so the result
is bit for bit what aten gives for a convolution with its bias (cuDNN
without the bias, then ``output.add_(bias)``), the FPN's ``lat +
F.interpolate(...)`` and ``F.relu``.

On a CUDA tensor :func:`conv_epilogue` launches the hand-written kernel of
``csrc/conv_epilogue.cu`` (:func:`conv_epilogue_cuda`), which writes over
``x``, the convolution's own output; on a CPU tensor it runs
:func:`conv_epilogue_plain`, the eager op sequence. The kernel takes float32
and bfloat16, dense NCHW or dense channels-last, chosen by the input's own
layout; a coarse level in another layout is copied to the input's once. It
has no backward: :func:`detectron_tpu_torch.models.precision.conv_bias_act`
takes it only where no gradient is recorded.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from detectron_tpu_torch import _build
from detectron_tpu_torch.ops.frozen_bn import kernel_layout

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def eager_tail(y, relu: bool = False, coarse=None):
    """What the eager chain does after the bias: ``+ F.interpolate(coarse)``
    (2x nearest), then ``F.relu``."""
    if coarse is not None:
        y = y + F.interpolate(coarse, scale_factor=2, mode="nearest")
    return F.relu(y) if relu else y


def conv_epilogue_plain(x, bias, relu: bool = False, coarse=None):
    """The eager op sequence: ``x + bias``, then :func:`eager_tail`;
    ``bias`` is ``[C]`` in ``x``'s dtype."""
    return eager_tail(x + bias[None, :, None, None], relu, coarse)


@functools.cache
def _conv_epilogue_lib() -> ctypes.CDLL:
    lib = _build.load("conv_epilogue")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.conv_epilogue.argtypes = [i32] + [ptr] * 3 + [ctypes.c_longlong] + [i32] * 3 + [ptr]
    lib.conv_epilogue.restype = i32
    return lib


def _checked_coarse(x, coarse, layout, what):
    n, c, h, w = x.shape
    if coarse.shape != (n, c, h // 2, w // 2) or h % 2 or w % 2:
        raise ValueError(f"{what}: coarse level {tuple(coarse.shape)} under {tuple(x.shape)}, "
                         f"want [N, C, H/2, W/2] of even H and W")
    if coarse.dtype != x.dtype or coarse.get_device() != x.get_device():
        raise ValueError(f"{what}: coarse level {coarse.dtype} on {coarse.device}, want "
                         f"{x.dtype} on {x.device}")
    return coarse.contiguous(memory_format=layout)


def conv_epilogue_cuda(x, bias, relu: bool = False, coarse=None):
    """:func:`conv_epilogue_plain` as one launch of ``csrc/conv_epilogue.cu``,
    written over ``x`` (over a dense copy where ``x`` is neither dense NCHW
    nor dense channels-last). Returns the tensor written. Never
    synchronises with the host; counts its launches (none for an empty
    ``x``). Lean on the host: it stands in for aten ops that issue from
    C++, so it reads each tensor attribute once, checks the coarse level
    only where there is one, and enters no device context where ``x`` is on
    the current device."""
    what = "conv_epilogue_cuda"
    dtype = x.dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, not {dtype}")
    if not x.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if x.dim() != 4:
        raise ValueError(f"{what}: shape {tuple(x.shape)}, want [N, C, H, W]")
    n, c, h, w = x.shape
    index = x.get_device()
    if bias.shape != (c,) or bias.dtype != dtype or bias.get_device() != index:
        raise ValueError(f"{what}: a bias of {tuple(bias.shape)} {bias.dtype} on {bias.device}, "
                         f"want ({c},) {dtype} on {x.device}")
    x, layout = kernel_layout(x)
    if coarse is not None:
        coarse = _checked_coarse(x, coarse, layout, what)
    if not x.numel():
        return x
    if not bias.is_contiguous():
        bias = bias.contiguous()
    flags = ((dtype == torch.bfloat16) + (2 if layout == torch.channels_last else 0)
             + (4 if relu else 0))
    args = (flags, x.data_ptr(), bias.data_ptr(), None if coarse is None else coarse.data_ptr(),
            n, c, h, w, _build.stream_handle(x.device))
    if index == torch.cuda.current_device():
        err = _conv_epilogue_lib().conv_epilogue(*args)
    else:
        with torch.cuda.device(index):
            err = _conv_epilogue_lib().conv_epilogue(*args)
    _build.check(err, what)
    conv_epilogue_cuda.launches += 1
    return x


conv_epilogue_cuda.launches = 0


def conv_epilogue(x, bias, relu: bool = False, coarse=None):
    """``relu?(x + bias [+ up2(coarse)])``: the kernel over ``x`` on a CUDA
    tensor, the eager op sequence on a CPU tensor. No gradient."""
    fwd = conv_epilogue_cuda if x.is_cuda else conv_epilogue_plain
    return fwd(x, bias, relu=relu, coarse=coarse)
