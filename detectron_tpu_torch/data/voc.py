"""Pascal VOC dataset adapter (XML annotations, 20 classes).

The port of ``detectron_tpu/data/voc.py``: parses ``Annotations/*.xml``
with ``xml.etree``, honours the ``difficult`` flag (excluded from training,
kept for the eval protocol), classes indexed 1..20 with background 0. The
JPEG decode needs ``cv2`` (``data.coco.import_cv2``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from detectron_tpu_torch.data.coco import import_cv2

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
VOC_CLASS_TO_ID = {n: i for i, n in enumerate(VOC_CLASSES)}


def parse_voc_xml(path: str) -> dict:
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    boxes, classes, difficult = [], [], []
    for obj in root.findall("object"):
        name = obj.find("name").text.strip().lower()
        if name not in VOC_CLASS_TO_ID:
            continue
        bb = obj.find("bndbox")
        # VOC coords are 1-based inclusive
        x1 = float(bb.find("xmin").text) - 1
        y1 = float(bb.find("ymin").text) - 1
        x2 = float(bb.find("xmax").text) - 1
        y2 = float(bb.find("ymax").text) - 1
        boxes.append([x1, y1, x2, y2])
        classes.append(VOC_CLASS_TO_ID[name])
        d = obj.find("difficult")
        difficult.append(int(d.text) if d is not None else 0)
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "classes": np.asarray(classes, np.int32),
        "difficult": np.asarray(difficult, np.int32),
        "hw": (h, w),
    }


class VocDataset:
    """VOC2007/2012-layout dataset. root contains JPEGImages/, Annotations/,
    ImageSets/Main/<split>.txt."""

    def __init__(self, root: str, split: str = "test", keep_difficult: bool = False):
        self.root = root
        self.keep_difficult = keep_difficult
        list_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(list_file) as f:
            self.ids = [line.strip().split()[0] for line in f if line.strip()]
        self._index_by_id = {x: i for i, x in enumerate(self.ids)}

    def index_of(self, image_id) -> int:
        return self._index_by_id[image_id]

    def __len__(self):
        return len(self.ids)

    @property
    def num_classes(self):
        return len(VOC_CLASSES)

    @property
    def class_names(self):
        return list(VOC_CLASSES)

    def example(self, index: int) -> dict:
        image_id = self.ids[index]
        ann = parse_voc_xml(os.path.join(self.root, "Annotations", image_id + ".xml"))
        cv2 = import_cv2("JPEG decode")
        img = cv2.imread(
            os.path.join(self.root, "JPEGImages", image_id + ".jpg"),
            cv2.IMREAD_COLOR,
        )
        if img is None:
            raise FileNotFoundError(image_id)
        keep = (
            np.ones(len(ann["classes"]), bool)
            if self.keep_difficult
            else ann["difficult"] == 0
        )
        return {
            "image": img[:, :, ::-1],
            "boxes": ann["boxes"][keep],
            "classes": ann["classes"][keep],
            "masks": None,
            # aligned with the filtered boxes/classes above (all zeros when
            # keep_difficult=False); full arrays are under all_*
            "difficult": ann["difficult"][keep],
            "all_boxes": ann["boxes"],
            "all_classes": ann["classes"],
            "all_difficult": ann["difficult"],
            "image_id": image_id,
            "orig_hw": ann["hw"],
        }
