"""Carry the JAX package's detector weights into the port.

``from_jax_params(variables)`` takes the variables tree of
``detectron_tpu``'s ``TwoStageDetector`` (``{"params": {"backbone": ...,
"fpn": ..., "rpn": ..., "box_head": ..., "mask_head": ...}}``),
``RetinaNet`` (``{"params": {"backbone": ..., "fpn": ..., "head": ...}}``)
or ``RFCN`` (``{"params": {"backbone": ..., "trunk": ..., "rpn": ...,
"ps_cls": ..., "ps_box": ...}}``)
as nested dicts of numpy arrays and returns the port's ``state_dict``:

* conv kernels HWIO -> OIHW;
* Dense kernels ``(in, out)`` -> ``(out, in)``; fc1 needs no permute,
  because the port flattens pooled features HWC as JAX does;
* the mask head's flax ``ConvTranspose`` kernel ``(kh, kw, in, out)`` ->
  torch ``(in, out, kh, kw)`` with a spatial flip (flax computes a
  fractionally strided correlation, torch the adjoint of a convolution;
  the inverse of ``detectron_tpu/utils/torch_weights.py``'s import);
* frozen BatchNorm ``weight/bias/running_mean/running_var`` as they are;
* RetinaNet's ``fpn/lateral2`` and ``fpn/smooth2`` are dropped: the JAX
  P3-P7 FPN makes them and never reads its P2, and the port's has neither.

Every leaf must map by one of these rules, and with ``expected`` (the
port's module or a state dict) the result must have exactly its keys and
shapes: a leftover or missing key raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_MODULES = {"backbone": "backbone", "fpn": "fpn", "rpn": "rpn_head",
            "box_head": "box_head", "mask_head": "mask_head", "head": "head",
            "trunk": "trunk", "ps_cls": "ps_cls", "ps_box": "ps_box"}
# the JAX RetinaNet's parameters that only its unused P2 reads
_RETINANET_UNREAD = (("fpn", "lateral2"), ("fpn", "smooth2"))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if path[0] not in _MODULES:
        raise KeyError(f"JAX parameter {'/'.join(path)}: unknown module {path[0]!r}")
    names = [_MODULES[path[0]]]
    for part in path[1:-1]:
        m = re.fullmatch(r"layer(\d)_(\d+)", part)
        names.extend([f"layer{m.group(1)}", m.group(2)] if m else [part])
    leaf = path[-1]
    if leaf == "kernel":
        if path[-2] == "deconv" and arr.ndim == 4:
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"JAX parameter {'/'.join(path)}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf not in _BN_LEAVES:
        raise KeyError(f"JAX parameter {'/'.join(path)}: unknown leaf {leaf!r}")
    return ".".join(names + [leaf]), np.ascontiguousarray(arr, dtype=np.float32)


def from_jax_params(variables: dict, expected=None) -> dict:
    """JAX variables tree -> the port's state dict (CPU float32 tensors)."""
    params = variables["params"] if "params" in variables else variables
    out = {}
    retinanet = "head" in params
    for path, value in _flatten(params):
        if retinanet and tuple(path[:2]) in _RETINANET_UNREAD:
            continue
        key, arr = _convert(tuple(str(p) for p in path), np.asarray(value))
        if key in out:
            raise KeyError(f"two JAX parameters map to {key!r}")
        out[key] = torch.tensor(arr)
    if expected is not None:
        want = expected.state_dict() if hasattr(expected, "state_dict") else expected
        missing = sorted(set(want) - set(out))
        leftover = sorted(set(out) - set(want))
        if missing or leftover:
            raise KeyError(f"from_jax_params: missing {missing}, leftover {leftover}")
        for key, value in want.items():
            if tuple(value.shape) != tuple(out[key].shape):
                raise ValueError(f"{key}: shape {tuple(out[key].shape)} from JAX, "
                                 f"{tuple(value.shape)} in the port")
    return out
