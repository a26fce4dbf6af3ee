"""COCO dataset adapter, self-contained (no pycocotools).

The port of ``detectron_tpu/data/coco.py``: annotation JSON parsing, COCO's
non-contiguous category ids mapped to contiguous 1..K (0 = background /
padding, the inverse map kept for result dumping), crowd (iscrowd=1)
instances kept apart as ignore regions, and every segmentation form to a
full-image RLE (``segmentation_to_rle``).

JPEG decode (``load_image``) and polygon rasters (``rasterize_full``,
``polygons_to_boxframe_mask``) need ``cv2``, imported when they run; where
it is missing they raise ``ImportError`` saying so. RLE segmentations (the
crowd regions, dicts) need no ``cv2``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from detectron_tpu_torch.native import RLE


def import_cv2(what: str):
    """``cv2``, or an ``ImportError`` that names what needed it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed: JPEG decode and "
            "polygon rasters have no other implementation in this package; use "
            "RLE segmentations and in-memory images where cv2 is missing") from e
    return cv2


@dataclass
class CocoAnnotations:
    images: list  # dicts: id, file_name, height, width
    anns_by_image: dict  # image id -> list of ann dicts
    cat_id_to_contiguous: dict
    contiguous_to_cat_id: dict
    class_names: list = field(default_factory=list)


def load_coco_json(path: str) -> CocoAnnotations:
    with open(path) as f:
        d = json.load(f)
    cats = sorted(d.get("categories", []), key=lambda c: c["id"])
    cat_map = {c["id"]: i + 1 for i, c in enumerate(cats)}
    inv = {v: k for k, v in cat_map.items()}
    anns_by_image: dict = {im["id"]: [] for im in d["images"]}
    for a in d.get("annotations", []):
        if a["image_id"] in anns_by_image:
            anns_by_image[a["image_id"]].append(a)
    return CocoAnnotations(
        images=d["images"],
        anns_by_image=anns_by_image,
        cat_id_to_contiguous=cat_map,
        contiguous_to_cat_id=inv,
        class_names=["__background__"] + [c["name"] for c in cats],
    )


def polygons_to_boxframe_mask(
    segmentation, box_xyxy, mask_size: int
) -> np.ndarray:
    """Rasterize polygon segmentation into a ``mask_size**2`` grid over the
    gt box (the fixed-frame raster consumed by layers/mask_target.py)."""
    x1, y1, x2, y2 = box_xyxy
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    canvas = np.zeros((mask_size, mask_size), np.uint8)
    if not isinstance(segmentation, list):  # RLE crowd - not rasterized here
        return canvas.astype(np.float32)
    cv2 = import_cv2("polygon rasterization")
    polys = []
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        pts[:, 0] = (pts[:, 0] - x1) / w * mask_size
        pts[:, 1] = (pts[:, 1] - y1) / h * mask_size
        polys.append(np.round(pts).astype(np.int32))
    cv2.fillPoly(canvas, polys, 1)
    return canvas.astype(np.float32)


class CocoDataset:
    """Iterable of raw examples: image (uint8 HWC), boxes (xyxy), classes,
    optional box-frame masks, and ids for evaluation."""

    def __init__(
        self,
        root: str,
        split: str = "val2017",
        ann_file: str | None = None,
        with_masks: bool = False,
        mask_size: int = 28,
    ):
        self.root = root
        self.split = split
        self.with_masks = with_masks
        self.mask_size = mask_size
        ann = ann_file or os.path.join(
            root, "annotations", f"instances_{split}.json"
        )
        self.coco = load_coco_json(ann)
        self.image_dir = os.path.join(root, split)
        self._index_by_id = {im["id"]: i for i, im in enumerate(self.coco.images)}

    def index_of(self, image_id) -> int:
        return self._index_by_id[image_id]

    def __len__(self):
        return len(self.coco.images)

    @property
    def num_classes(self):  # incl. background
        return len(self.coco.contiguous_to_cat_id) + 1

    def load_image(self, info) -> np.ndarray:
        cv2 = import_cv2("JPEG decode")
        path = os.path.join(self.image_dir, info["file_name"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1]  # BGR -> RGB

    def example(self, index: int) -> dict:
        info = self.coco.images[index]
        all_anns = self.coco.anns_by_image[info["id"]]
        anns = [a for a in all_anns if not a.get("iscrowd", 0)]
        crowd = [a for a in all_anns if a.get("iscrowd", 0)]
        crowd_boxes = np.asarray(
            [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
              a["bbox"][1] + a["bbox"][3]] for a in crowd], np.float32,
        ).reshape(-1, 4)
        crowd_classes = np.asarray(
            [self.coco.cat_id_to_contiguous[a["category_id"]] for a in crowd],
            np.int32,
        )
        boxes = np.zeros((len(anns), 4), np.float32)
        classes = np.zeros((len(anns),), np.int32)
        # annotation (segmentation) areas: the COCO ``ann["area"]`` field
        # that the evaluator buckets gts by in BOTH bbox and segm eval
        areas = np.asarray(
            [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns],
            np.float64,
        )
        crowd_areas = np.asarray(
            [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in crowd],
            np.float64,
        )
        masks = None
        if self.with_masks:
            masks = np.zeros((len(anns), self.mask_size, self.mask_size), np.float32)
        for i, a in enumerate(anns):
            x, y, w, h = a["bbox"]
            boxes[i] = [x, y, x + w, y + h]
            classes[i] = self.coco.cat_id_to_contiguous[a["category_id"]]
            if self.with_masks and "segmentation" in a:
                masks[i] = polygons_to_boxframe_mask(
                    a["segmentation"], boxes[i], self.mask_size
                )
        return {
            "image": self.load_image(info),
            "boxes": boxes,
            "classes": classes,
            "areas": areas,
            "crowd_areas": crowd_areas,
            "masks": masks,
            "polygons": [a.get("segmentation") for a in anns],
            # crowd regions: excluded from training, absorb detections in eval
            "crowd_boxes": crowd_boxes,
            "crowd_classes": crowd_classes,
            "crowd_segmentations": [a.get("segmentation") for a in crowd],
            "image_id": info["id"],
            "orig_hw": (info["height"], info["width"]),
        }

    @staticmethod
    def segmentation_to_rle(seg, hw) -> RLE:
        """Any COCO segmentation -> RLE in full-image coords: polygon lists
        are rasterized; crowd RLEs (uncompressed count lists or compressed
        strings) are decoded directly by the codec, so the COCO crowd-absorb
        rule applies to segm eval too."""
        h, w = int(hw[0]), int(hw[1])
        if isinstance(seg, dict):
            sh, sw = (int(v) for v in seg.get("size", (h, w)))
            counts = seg["counts"]
            if isinstance(counts, str):
                return RLE.from_string(counts, sh, sw)
            return RLE(sh, sw, np.asarray(counts, np.uint32))
        if isinstance(seg, list) and seg:
            return RLE.encode(CocoDataset.rasterize_full(seg, hw))
        return RLE.encode(np.zeros((h, w), bool))

    @staticmethod
    def rasterize_full(polygons, hw) -> np.ndarray:
        """Full-image binary mask from polygon segmentation (for segm eval)."""
        h, w = hw
        canvas = np.zeros((h, w), np.uint8)
        if isinstance(polygons, list):
            cv2 = import_cv2("polygon rasterization")
            pts = [
                np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
                for p in polygons
            ]
            cv2.fillPoly(canvas, pts, 1)
        return canvas.astype(bool)
