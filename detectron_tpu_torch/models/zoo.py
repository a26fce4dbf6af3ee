"""Model zoo / detector factory: the config-driven public API.

The port of ``detectron_tpu/models/zoo.py`` for inference:
``build_detector(cfg, device=None)`` returns a :class:`Detector` whose
``predict_fn(params, batch)`` takes

    batch = {
      "image":    [B, H, W, 3] float32 (normalized, NHWC),
      "image_hw": [B, 2] float32 true (unpadded) sizes,
    }

and returns ``(Detections, mask_probs [B, D, 28, 28] | None)``. ``params``
is a state dict (``Detector.init`` or ``utils.weights.from_jax_params``),
or None for the module's own weights. The default device is the card;
without CUDA that default raises, it does not fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from detectron_tpu_torch.models import faster_rcnn as frcnn

MODEL_NAMES = ("faster_rcnn", "mask_rcnn", "retinanet", "rfcn")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on "
                           "the CPU")
    return device


def _init_std(name: str, shape) -> float:
    """Standard deviation of the random init of one weight, following the
    JAX modules' initializers (He fan-out for backbone and mask convs,
    small normals for the prediction layers, LeCun fan-in elsewhere)."""
    if name.startswith("rpn_head."):
        return 0.01
    if name.startswith("box_head.cls_score"):
        return 0.01
    if name.startswith(("box_head.bbox_pred", "mask_head.mask_logits")):
        return 0.001
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    if name.startswith("backbone.") or (name.startswith("mask_head.conv")):
        return float(np.sqrt(2.0 / (shape[0] * receptive)))
    fan_in = shape[0] * receptive if name.startswith("mask_head.deconv") else shape[1] * receptive
    return float(np.sqrt(1.0 / fan_in))


class Detector:
    """A two-stage detector module on a device, with the JAX Detector's
    pure-function interface."""

    def __init__(self, cfg, device=None):
        name = cfg.model.name
        if name not in MODEL_NAMES:
            raise ValueError(f"unknown model {name!r}; zoo: {MODEL_NAMES}")
        if name in ("retinanet", "rfcn"):
            raise NotImplementedError(
                f"model {name!r} is not ported yet: ROADMAP.md, Queue 1, "
                + ("RetinaNet" if name == "retinanet" else "R-FCN"))
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.with_masks = name == "mask_rcnn"
        self.module = frcnn.build_two_stage(cfg, include_mask=self.with_masks)
        self.module.to(device=self.device).eval()

    def init(self, seed: int = 0) -> dict:
        """A random state dict on the device, drawn from a numpy seed:
        normal weights with the JAX modules' scales, zero biases, identity
        frozen BatchNorm."""
        rng = np.random.RandomState(seed)
        params = {}
        for key, value in self.module.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("running_var",) or (leaf == "weight" and value.dim() == 1):
                arr = np.ones(value.shape, np.float32)
            elif leaf in ("bias", "running_mean"):
                arr = np.zeros(value.shape, np.float32)
            else:
                std = _init_std(key, tuple(value.shape))
                arr = (rng.standard_normal(value.shape) * std).astype(np.float32)
            params[key] = torch.as_tensor(arr, device=self.device)
        return params

    def predict_fn(self, params, batch):
        """Returns ``(Detections, mask_probs | None)``."""
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=self.device)
        image_hw = torch.as_tensor(batch["image_hw"], dtype=torch.float32,
                                   device=self.device)
        with torch.no_grad():
            if params is None:
                return self.module(images, image_hw, with_masks=self.with_masks)
            params = {k: v.to(self.device) for k, v in params.items()}
            return functional_call(self.module, params, (images, image_hw),
                                   {"with_masks": self.with_masks}, strict=True)


def build_detector(cfg, device=None) -> Detector:
    return Detector(cfg, device=device)
