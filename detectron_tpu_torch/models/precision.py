"""Layers that keep float32 parameters and compute in another dtype.

The port of what ``dtype=`` does to a flax ``nn.Conv``, ``nn.ConvTranspose``
or ``nn.Dense`` in the JAX package (``model.dtype=bfloat16``): the input,
the kernel and the bias are cast to the compute dtype, the layer computes
and returns that dtype, and the parameters stay float32, the master copy,
so autograd gives them float32 gradients. These are explicit casts, not
``torch.autocast``, whose op policy would run softmax, ``log_softmax`` and
the losses in float32 where the reference runs them in the compute dtype.
In float32 every cast is a no-op.

``memory_format`` is the layout a convolution's kernel is cast to (with
its dtype, in one pass): ``torch.channels_last`` where the detector runs
its convolutions channels-last, else ``torch.contiguous_format``.

:func:`conv_bias_act` runs a convolution with the bias, the ReLU and the
FPN's top-down add after it: where no gradient is recorded, as the
convolution without its bias and one pass of ``ops/conv_epilogue.py`` over
its output; else as the eager ops.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from detectron_tpu_torch.ops import conv_epilogue as ce

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``model.dtype`` config value."""
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: want one of {sorted(DTYPES)}")
    return DTYPES[name]


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class _BiasApart:
    """``forward`` with the bias, and ``forward_unbiased`` without it, of a
    layer whose ``_run(x, bias)`` computes in ``compute_dtype``."""

    def forward(self, x):
        return self._run(x, _cast(self.bias, self.compute_dtype))

    def forward_unbiased(self, x):
        """The layer without its bias, and the bias in the compute dtype
        (None without one), for a pass that adds it."""
        return self._run(x, None), _cast(self.bias, self.compute_dtype)


class Conv2d(_BiasApart, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.memory_format = torch.contiguous_format

    def _run(self, x, bias):
        dt = self.compute_dtype
        weight = self.weight.to(dt, memory_format=self.memory_format)
        return self._conv_forward(x.to(dt), weight, bias)


class ConvTranspose2d(_BiasApart, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.memory_format = torch.contiguous_format

    def _run(self, x, bias):
        dt = self.compute_dtype
        weight = self.weight.to(dt, memory_format=self.memory_format)
        return F.conv_transpose2d(x.to(dt), weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def conv_bias_act(conv, x, relu: bool = False, coarse=None):
    """``relu?(conv(x) [+ up2(coarse)])`` for a convolution with a bias,
    where ``up2`` is the 2x nearest upsample of the coarser level (the
    FPN's top-down add). Where no gradient is recorded, the convolution runs
    without its bias and one pass (``ops/conv_epilogue.py``: the kernel over
    the convolution's own output on CUDA tensors, its eager twin on CPU
    tensors) adds the bias and the coarse level and applies the ReLU; else
    ``conv(x)`` runs with its bias, then the same eager tail
    (:func:`~detectron_tpu_torch.ops.conv_epilogue.eager_tail`), so that
    autograd records the graph it always has."""
    recording = torch.is_grad_enabled() and (
        x.requires_grad or conv.weight.requires_grad or conv.bias.requires_grad
        or (coarse is not None and coarse.requires_grad))
    if recording:
        return ce.eager_tail(conv(x), relu, coarse)
    y, bias = conv.forward_unbiased(x)
    return ce.conv_epilogue(y, bias, relu=relu, coarse=coarse)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
