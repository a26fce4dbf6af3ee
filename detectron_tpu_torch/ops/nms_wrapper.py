"""NMS dispatch: the port of ``detectron_tpu/ops/nms_wrapper.py``.

One padded contract, ``(idx [max_out] int32, valid [max_out] bool)``
(:func:`detectron_tpu_torch.ops.nms.nms_padded`'s), served by the greedy
walk that ``impl`` names, with the sort and the compaction around it
shared (``nms_padded_batched``):

* ``impl="jnp"``: the exact oracle, :func:`greedy_keep_plain` (plain
  PyTorch) on the tensors' own device, CUDA tensors included. No model
  path calls it;
* ``impl="pallas"``: kernel K1, :func:`greedy_keep_cuda` (the port of
  ``detectron_tpu/ops/nms_pallas.py::nms_pallas``), on CUDA tensors. On
  CPU tensors it raises: nothing falls back. With ``interpret=True`` it
  runs K1's plain walk on the tensors' device instead, the counterpart of
  running the Pallas kernel in interpret mode: the caller's explicit
  choice of the oracle, on the CPU or on the card.

``nms_numpy`` (the host oracle) and ``nms_padded`` are re-exported, as the
JAX module re-exports them.
"""

from __future__ import annotations

import torch

from detectron_tpu_torch.ops import nms as _nms
from detectron_tpu_torch.ops.nms import nms_numpy, nms_padded  # noqa: F401


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int,
        valid: torch.Tensor | None = None, offset: float = 0.0, impl: str = "jnp",
        interpret: bool = False):
    """Greedy NMS of one problem, boxes ``[N, 4]`` and scores ``[N]``, by
    the walk ``impl`` names (see the module). Returns ``(idx [max_out]
    int32, valid [max_out] bool)``."""
    if impl == "pallas":
        if interpret:
            keep_fn = _nms.greedy_keep_plain
        elif boxes.is_cuda:
            keep_fn = _nms.greedy_keep_cuda
        else:
            raise ValueError(f"nms(impl='pallas') runs kernel K1 on CUDA tensors, not on "
                             f"{boxes.device}; pass interpret=True for its plain walk there")
    elif impl == "jnp":
        keep_fn = _nms.greedy_keep_plain
    else:
        raise ValueError(f"unknown nms impl {impl!r}")
    idx, ok = _nms.nms_padded_batched(boxes[None], scores[None],
                                      None if valid is None else valid[None], iou_threshold,
                                      max_out, offset, keep_fn=keep_fn)
    return idx[0], ok[0]
