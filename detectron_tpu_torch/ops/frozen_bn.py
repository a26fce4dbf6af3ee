"""Frozen BatchNorm, its ReLU and the residual add as one pass.

``y = relu(x * scale + bias [+ residual])`` over NCHW-shaped tensors, with
three forms: the affine alone (the stem, ``bn1``, ``bn2``), an identity
residual (``bn3`` with the block's input), and a downsampled residual whose
own frozen norm is applied in the same pass (``bn3`` with the raw
downsample conv output and that norm's scale and bias). Every op is
rounded to the tensor's dtype as the eager chain rounds it, so the result
is bit for bit the eager ``x * s + b``, ``+ residual`` and ``F.relu`` of
``models/resnet.py`` before this pass existed; the gradient likewise.

On a CUDA tensor :func:`frozen_bn_act` launches the hand-written kernel of
``csrc/frozen_bn.cu`` (:func:`frozen_bn_act_cuda`, and
:func:`frozen_bn_act_backward_cuda` for the gradient); on a CPU tensor it
runs :func:`frozen_bn_act_plain` and :func:`frozen_bn_act_backward_plain`,
the eager op sequence. The kernel takes float32 and bfloat16, dense NCHW
or dense channels-last, chosen by the input's own layout; a residual or
gradient in another layout is copied to the input's once.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from detectron_tpu_torch import _build

FORMS = ("affine", "identity", "downsample")  # the kernel's form codes, in order
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def form_of(residual: torch.Tensor | None, res_scale: torch.Tensor | None) -> int:
    """0 without a residual, 1 for an identity residual, 2 for a residual
    with its own scale and bias (the downsample)."""
    return 0 if residual is None else 1 if res_scale is None else 2


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def frozen_bn_act_plain(x, scale, bias, residual=None, res_scale=None, res_bias=None):
    """The eager op sequence: ``x * s + b``, the downsample's own ``d * sd +
    bd``, the residual add, ``F.relu``; ``scale`` and the others are ``[C]``."""
    y = x * _channel(scale) + _channel(bias)
    if residual is not None:
        if res_scale is not None:
            residual = residual * _channel(res_scale) + _channel(res_bias)
        y = y + residual
    return F.relu(y)


def frozen_bn_act_backward_plain(grad, y, scale, res_scale=None, form: int = 0):
    """Eager autograd's gradient of :func:`frozen_bn_act_plain` from the
    output ``y``: ReLU's ``threshold_backward``, then the multiply's
    ``grad * scale``. Returns ``(gx, gr)``: the gradient of ``x`` and, for
    ``form`` 1 or 2, of the residual (``None`` for form 0)."""
    gz = torch.ops.aten.threshold_backward(grad, y, 0)
    gx = gz * _channel(scale)
    gr = None if form == 0 else gz if form == 1 else gz * _channel(res_scale)
    return gx, gr


@functools.cache
def _frozen_bn_lib() -> ctypes.CDLL:
    lib = _build.load("frozen_bn")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    tail = [ctypes.c_longlong, i32, ctypes.c_longlong, ptr]
    lib.frozen_bn_forward.argtypes = [i32] * 3 + [ptr] * 7 + tail
    lib.frozen_bn_backward.argtypes = [i32] * 3 + [ptr] * 6 + tail
    lib.frozen_bn_forward.restype = lib.frozen_bn_backward.restype = i32
    return lib


def kernel_layout(x: torch.Tensor) -> tuple[torch.Tensor, torch.memory_format]:
    """``x`` as the kernel reads it and its layout: dense NCHW (checked
    first: where C or H*W is 1 a tensor is both, and both readings give an
    element the same channel), dense channels-last, else a dense NCHW
    copy."""
    if x.is_contiguous():
        return x, torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return x, torch.channels_last
    return x.contiguous(), torch.contiguous_format


def _check(x, vectors, what):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, not {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")
    if x.dim() != 4:
        raise ValueError(f"{what}: shape {tuple(x.shape)}, want [N, C, H, W]")
    for v in vectors:
        if v is not None and (v.shape != (x.shape[1],) or v.dtype != x.dtype
                              or v.device != x.device):
            raise ValueError(f"{what}: a scale or bias of {tuple(v.shape)} {v.dtype} on "
                             f"{v.device}, want ({x.shape[1]},) {x.dtype} on {x.device}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def frozen_bn_act_cuda(x, scale, bias, residual=None, res_scale=None, res_bias=None):
    """:func:`frozen_bn_act_plain` as one launch of ``csrc/frozen_bn.cu``
    (the form from the residual and its scale), in ``x``'s layout. Never
    synchronises with the host; counts its launches."""
    what = "frozen_bn_act_cuda"
    _check(x, (scale, bias, res_scale, res_bias), what)
    form = form_of(residual, res_scale)
    if form == 2 and res_bias is None:
        raise ValueError(f"{what}: a residual scale without its bias")
    x, layout = kernel_layout(x)
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype or residual.device != x.device:
            raise ValueError(f"{what}: residual {tuple(residual.shape)} {residual.dtype}, want "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        residual = residual.contiguous(memory_format=layout)
    vectors = [v if v is None else v.contiguous() for v in (scale, bias, res_scale, res_bias)]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=layout)
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _frozen_bn_lib().frozen_bn_forward(
            int(x.dtype == torch.bfloat16), form, int(layout == torch.channels_last),
            x.data_ptr(), _ptr(residual), *map(_ptr, vectors), y.data_ptr(),
            x.numel(), c, h * w, _build.stream_handle(x.device))
    _build.check(err, what)
    frozen_bn_act_cuda.launches += 1
    return y


frozen_bn_act_cuda.launches = 0


def frozen_bn_act_backward_cuda(grad, y, scale, res_scale=None, form: int = 0):
    """:func:`frozen_bn_act_backward_plain` as one launch of
    ``csrc/frozen_bn.cu``: ``grad`` is read in ``y``'s layout (copied once if
    it comes in another), the gradients are written in it. Counts its
    launches."""
    what = "frozen_bn_act_backward_cuda"
    _check(y, (scale, res_scale), what)
    if form not in (0, 1, 2) or (form == 2) != (res_scale is not None):
        raise ValueError(f"{what}: form {form} with{'out' * (res_scale is None)} a residual "
                         "scale")
    y, layout = kernel_layout(y)
    if grad.shape != y.shape or grad.dtype != y.dtype or grad.device != y.device:
        raise ValueError(f"{what}: gradient {tuple(grad.shape)} {grad.dtype}, want "
                         f"{tuple(y.shape)} {y.dtype} on {y.device}")
    grad = grad.contiguous(memory_format=layout)
    gx = torch.empty_like(y, memory_format=layout)
    gr = torch.empty_like(y, memory_format=layout) if form else None
    n, c, h, w = y.shape
    with torch.cuda.device(y.device):
        err = _frozen_bn_lib().frozen_bn_backward(
            int(y.dtype == torch.bfloat16), form, int(layout == torch.channels_last),
            grad.data_ptr(), y.data_ptr(), scale.contiguous().data_ptr(),
            _ptr(None if res_scale is None else res_scale.contiguous()), gx.data_ptr(),
            _ptr(gr), y.numel(), c, h * w, _build.stream_handle(y.device))
    _build.check(err, what)
    frozen_bn_act_backward_cuda.launches += 1
    return gx, gr


frozen_bn_act_backward_cuda.launches = 0


class FrozenBNActFunction(torch.autograd.Function):
    """:func:`frozen_bn_act` with its gradient, kernel or plain by the
    input's device. Saves the output and the scales only (the output is
    the next convolution's input, which autograd keeps anyway); the scales
    and biases get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, res_scale, res_bias):
        fwd = frozen_bn_act_cuda if x.is_cuda else frozen_bn_act_plain
        y = fwd(x, scale, bias, residual, res_scale, res_bias)
        ctx.form = form_of(residual, res_scale)
        ctx.save_for_backward(y, scale, res_scale)
        return y

    @staticmethod
    def backward(ctx, grad):
        y, scale, res_scale = ctx.saved_tensors
        need_x, need_r = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        form = ctx.form if need_r else 0
        bwd = frozen_bn_act_backward_cuda if y.is_cuda else frozen_bn_act_backward_plain
        gx, gr = bwd(grad, y, scale, res_scale if form == 2 else None, form)
        return gx if need_x else None, None, None, gr, None, None


def frozen_bn_act(x, scale, bias, residual=None, res_scale=None, res_bias=None):
    """``relu(x * scale + bias + residual)``, where the residual, if any, is
    taken as it is (``res_scale`` None) or as ``residual * res_scale +
    res_bias``; ``scale`` and the others ``[C]`` in ``x``'s dtype.
    Differentiable in ``x`` and ``residual``; where neither needs a
    gradient, no graph is recorded."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or (residual is not None and residual.requires_grad))
    if needs_grad:
        return FrozenBNActFunction.apply(x, scale, bias, residual, res_scale, res_bias)
    fwd = frozen_bn_act_cuda if x.is_cuda else frozen_bn_act_plain
    return fwd(x, scale, bias, residual, res_scale, res_bias)
