"""CityPersons pedestrian dataset adapter.

The port of ``detectron_tpu/data/citypersons.py``: Cityscapes images with
``gtBboxCityPersons`` JSON annotations; pedestrians are class 1. The
published "Reasonable" protocol evaluates ``pedestrian`` only: ``rider``,
``sitting person``, ``person (other)``, ``person group`` and explicit
``ignore`` regions, and small (height < 50) or occluded (visible < 65%)
pedestrians, are ignore boxes, absorbed in evaluation (``eval/mr_eval.py``)
and excluded from training. ``positive_labels`` widens the positive set.
The PNG decode needs ``cv2`` (``data.coco.import_cv2``).

Layout (standard Cityscapes):
  root/leftImg8bit/<split>/<city>/<id>_leftImg8bit.png
  root/gtBboxCityPersons/<split>/<city>/<id>_gtBboxCityPersons.json
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from detectron_tpu_torch.data.coco import import_cv2

# labels in gtBboxCityPersons; "Reasonable" protocol positives/ignores
_POSITIVE_LABELS = {"pedestrian"}
_IGNORE_LABELS = {
    "rider", "sitting person", "person (other)", "ignore", "person group",
}


class CityPersonsDataset:
    """Pedestrian detection; 2 classes (bg + person)."""

    def __init__(
        self,
        root: str,
        split: str = "val",
        min_height: float = 50.0,
        min_vis_ratio: float = 0.65,
        positive_labels: set[str] | None = None,
    ):
        self.root = root
        self.split = split
        self.min_height = min_height
        self.min_vis_ratio = min_vis_ratio
        self.positive_labels = (
            set(positive_labels) if positive_labels is not None
            else set(_POSITIVE_LABELS)
        )
        # every non-positive person label is an ignore region
        self.ignore_labels = (
            (_POSITIVE_LABELS | _IGNORE_LABELS) - self.positive_labels
        )
        pattern = os.path.join(
            root, "gtBboxCityPersons", split, "*", "*_gtBboxCityPersons.json"
        )
        self.ann_files = sorted(glob.glob(pattern))
        if not self.ann_files:
            raise FileNotFoundError(f"no CityPersons annotations under {pattern}")
        self._id_to_index = {
            os.path.basename(p).replace("_gtBboxCityPersons.json", ""): i
            for i, p in enumerate(self.ann_files)
        }

    def __len__(self):
        return len(self.ann_files)

    def index_of(self, image_id) -> int:
        """Index of an image_id (the annotation basename without suffix)."""
        return self._id_to_index[image_id]

    @property
    def num_classes(self):
        return 2

    @property
    def class_names(self):
        return ["__background__", "person"]

    def _image_path(self, ann_path: str) -> str:
        rel = os.path.relpath(ann_path, os.path.join(self.root, "gtBboxCityPersons"))
        rel = rel.replace("_gtBboxCityPersons.json", "_leftImg8bit.png")
        return os.path.join(self.root, "leftImg8bit", rel)

    def example(self, index: int) -> dict:
        ann_path = self.ann_files[index]
        with open(ann_path) as f:
            ann = json.load(f)
        boxes, classes, ignore = [], [], []
        for obj in ann.get("objects", []):
            label = obj.get("label", "")
            x, y, w, h = obj["bbox"]
            is_ignore = label in self.ignore_labels
            if label in self.positive_labels:
                # "reasonable" filtering: small or occluded -> ignore
                vis = obj.get("bboxVis", obj["bbox"])
                vis_ratio = (vis[2] * vis[3]) / max(w * h, 1e-9)
                if h < self.min_height or vis_ratio < self.min_vis_ratio:
                    is_ignore = True
            elif not is_ignore:
                continue
            boxes.append([x, y, x + w, y + h])
            classes.append(1)
            ignore.append(is_ignore)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        classes = np.asarray(classes, np.int32)
        ignore = np.asarray(ignore, bool)
        cv2 = import_cv2("PNG decode")
        img = cv2.imread(self._image_path(ann_path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self._image_path(ann_path))
        keep = ~ignore
        return {
            "image": img[:, :, ::-1],
            "boxes": boxes[keep],
            "classes": classes[keep],
            "masks": None,
            "ignore_boxes": boxes[ignore],
            "all_boxes": boxes,
            "all_ignore": ignore,
            "image_id": os.path.basename(ann_path).replace(
                "_gtBboxCityPersons.json", ""
            ),
            "orig_hw": (ann.get("imgHeight", img.shape[0]),
                        ann.get("imgWidth", img.shape[1])),
        }
