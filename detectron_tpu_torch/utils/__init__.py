"""Utilities: timing, metrics logging, visualization, weight conversion."""

from detectron_tpu_torch.utils.timer import Timer  # noqa: F401
