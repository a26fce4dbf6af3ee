"""Backbone, FPN, heads, the two-stage detector and the mask paste.

Re-exports what ``detectron_tpu.models`` re-exports."""

from detectron_tpu_torch.models.fpn import FPN  # noqa: F401
from detectron_tpu_torch.models.resnet import FrozenBatchNorm, ResNet  # noqa: F401
from detectron_tpu_torch.models.retinanet import (  # noqa: F401
    Detections,
    RetinaNet,
    RetinaNetHead,
    retinanet_anchor_generator,
    retinanet_inference,
    retinanet_loss,
)
