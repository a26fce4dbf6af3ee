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
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``model.dtype`` config value."""
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: want one of {sorted(DTYPES)}")
    return DTYPES[name]


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.memory_format = torch.contiguous_format

    def forward(self, x):
        dt = self.compute_dtype
        weight = self.weight.to(dt, memory_format=self.memory_format)
        return self._conv_forward(x.to(dt), weight, _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.memory_format = torch.contiguous_format

    def forward(self, x):
        dt = self.compute_dtype
        weight = self.weight.to(dt, memory_format=self.memory_format)
        return F.conv_transpose2d(x.to(dt), weight, _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
