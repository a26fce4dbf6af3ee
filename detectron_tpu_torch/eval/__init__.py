"""Evaluation: the COCO, VOC and MR^-2 protocols, self-contained, and the
eval driver (``python -m detectron_tpu_torch.eval.driver``)."""

from detectron_tpu_torch.eval.coco_eval import evaluate as evaluate_coco  # noqa: F401
from detectron_tpu_torch.eval.mr_eval import evaluate_mr  # noqa: F401
from detectron_tpu_torch.eval.voc_eval import evaluate_voc, voc_ap  # noqa: F401
