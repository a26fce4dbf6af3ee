"""Model zoo / detector factory: the config-driven public API.

The port of ``detectron_tpu/models/zoo.py`` for Faster / Mask R-CNN,
RetinaNet and R-FCN: ``build_detector(cfg, device=None)`` returns a
:class:`Detector`
whose ``predict_fn(params, batch)`` takes

    batch = {
      "image":    [B, H, W, 3] float32 (normalized, NHWC),
      "image_hw": [B, 2] float32 true (unpadded) sizes,
    }

and returns ``(Detections, mask_probs [B, D, 28, 28] | None)`` (None for
RetinaNet, R-FCN and Faster R-CNN), and whose ``loss_fn(params, batch, draws)``
takes the batch with ``gt_boxes``, ``gt_classes`` and ``gt_masks`` added
and returns ``(total, loss_dict)``.
``params`` is a state dict (``Detector.init`` or
``utils.weights.from_jax_params``), or None for the module's own weights.
The default device is the card; without CUDA that default raises, it does
not fall back to the CPU. With ``model.dtype=bfloat16`` the inputs stay
float32 (the model casts them) and so do the parameters; the detector
computes in bf16 (``Detector.dtype``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from detectron_tpu_torch.models import faster_rcnn as frcnn
from detectron_tpu_torch.models import retinanet as retina
from detectron_tpu_torch.models import rfcn as rfcn_mod
from detectron_tpu_torch.ops.roi_align import check_roi_align_contract

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
    if name.startswith(("rpn_head.", "head.cls_score", "head.box_pred")):
        return 0.01
    if name.startswith("box_head.cls_score"):
        return 0.01
    if name.startswith(("box_head.bbox_pred", "mask_head.mask_logits", "ps_box.")):
        return 0.001
    if name.startswith("ps_cls."):
        return 0.01
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    if name.startswith("backbone.") or (name.startswith("mask_head.conv")):
        return float(np.sqrt(2.0 / (shape[0] * receptive)))
    fan_in = shape[0] * receptive if name.startswith("mask_head.deconv") else shape[1] * receptive
    return float(np.sqrt(1.0 / fan_in))


class Detector:
    """A detector module on a device, with the JAX Detector's pure-function
    interface. ``dtype``: the compute dtype. On the card a two-stage
    config that pools with RoIAlign is held to what the RoIAlign kernels
    take (``check_roi_align_contract``) when the detector is built;
    RoIPool (``roi.pool_type=pool``), RetinaNet and R-FCN (PSRoIPool) run
    no RoIAlign kernel and need no such check."""

    def __init__(self, cfg, device=None):
        name = cfg.model.name
        if name not in MODEL_NAMES:
            raise ValueError(f"unknown model {name!r}; zoo: {MODEL_NAMES}")
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.with_masks = name == "mask_rcnn"
        self.is_two_stage = name in ("faster_rcnn", "mask_rcnn")
        self.is_rfcn = name == "rfcn"
        if self.is_two_stage:
            self.module = frcnn.build_two_stage(cfg, include_mask=self.with_masks)
        elif self.is_rfcn:
            self.module = rfcn_mod.RFCN(cfg)
        else:
            self.module = retina.RetinaNet(cfg)
        self.dtype = self.module.dtype
        if (self.device.type == "cuda" and self.is_two_stage
                and cfg.roi.pool_type != "pool"):
            check_roi_align_contract(cfg, self.dtype, len(frcnn.ROI_STRIDES))
        self.module.to(device=self.device).eval()

    def init(self, seed: int = 0) -> dict:
        """A random state dict on the device, drawn from a numpy seed:
        normal weights with the JAX modules' scales, zero biases (RetinaNet's
        class logits: the prior's), identity frozen BatchNorm."""
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
        if self.name == "retinanet":
            params["head.cls_score.bias"].fill_(
                retina.prior_bias(self.cfg.retinanet.prior_prob))
        return params

    def batch_to_device(self, batch) -> dict:
        """The batch's arrays as tensors on the detector's device (class
        ids int64, everything else float32)."""
        return {k: torch.as_tensor(v, device=self.device,
                                   dtype=torch.int64 if k == "gt_classes" else torch.float32)
                for k, v in batch.items()}

    def loss_fn(self, params, batch, draws, mark=None):
        """Returns ``(total, loss_dict)`` of one training forward.

        ``batch`` adds ``gt_boxes [B, G, 4]``, ``gt_classes [B, G]`` (0 =
        padding) and, for Mask R-CNN, ``gt_masks [B, G, M0, M0]`` to the
        predict batch. ``params``: a state dict, or None for the module's
        own weights (gradients then reach its trainable parameters).
        ``draws``: a ``torch.Generator`` on the device, or the
        ``faster_rcnn.TrainDraws`` to sample with (RetinaNet samples
        nothing). ``mark``: None, or a callable given each stage's name
        once it is issued (``faster_rcnn.faster_rcnn_train_forward``).
        """
        batch = self.batch_to_device(batch)
        targets = {k: batch[k] for k in ("gt_boxes", "gt_classes")}
        if self.with_masks:
            targets["gt_masks"] = batch["gt_masks"]
        args = (batch["image"], batch["image_hw"])
        kwargs = {"targets": targets, "mark": mark}
        if self.is_two_stage or self.is_rfcn:
            kwargs["draws"] = draws
        if params is None:
            loss_dict = self.module(*args, **kwargs)
        else:
            params = {k: v.to(self.device) for k, v in params.items()}
            loss_dict = functional_call(self.module, params, args, kwargs, strict=True)
        return sum(loss_dict.values()), loss_dict

    def predict_fn(self, params, batch):
        """Returns ``(Detections, mask_probs | None)``."""
        images = torch.as_tensor(batch["image"], dtype=torch.float32, device=self.device)
        image_hw = torch.as_tensor(batch["image_hw"], dtype=torch.float32,
                                   device=self.device)
        kwargs = {"with_masks": self.with_masks} if self.is_two_stage else {}
        with torch.no_grad():
            if params is None:
                out = self.module(images, image_hw, **kwargs)
            else:
                params = {k: v.to(self.device) for k, v in params.items()}
                out = functional_call(self.module, params, (images, image_hw), kwargs,
                                      strict=True)
        return out if self.is_two_stage else (out, None)


def build_detector(cfg, device=None) -> Detector:
    return Detector(cfg, device=device)
