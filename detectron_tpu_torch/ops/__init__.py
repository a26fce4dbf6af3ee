"""Detection ops: box math, anchors, NMS, RoIAlign and RoIPool.

Re-exports what ``detectron_tpu.ops`` re-exports, each Pallas kernel's
name mapped to its port (``multilevel_roi_align_pallas`` ->
``multilevel_roi_align_cuda``). As there, names equal to a submodule's
(``roi_align``, ``nms_wrapper``, ``ps_roi_pool``) are not re-exported:
they would shadow the submodules.
"""

from detectron_tpu_torch.ops.boxes import (  # noqa: F401
    bbox_overlaps,
    box_area,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    pairwise_iou,
    valid_box_mask,
)
from detectron_tpu_torch.ops.anchors import (  # noqa: F401
    AnchorGenerator,
    generate_base_anchors,
    shift_anchors,
)
from detectron_tpu_torch.ops.nms import class_aware_nms, nms_numpy, nms_padded  # noqa: F401
from detectron_tpu_torch.ops.roi_align import (  # noqa: F401
    multilevel_roi_align,
    multilevel_roi_align_cuda,
    roi_pool,
)
