"""Proposal generation and the training targets.

Re-exports what ``detectron_tpu.layers`` re-exports, but the names of
submodules: ``anchor_target`` here is the module
``layers/anchor_target.py`` (the function is in it, and is batched: the
JAX package's per-image ``anchor_target_single`` has no counterpart of its
own)."""

from detectron_tpu_torch.layers.anchor_target import AnchorTargets  # noqa: F401
