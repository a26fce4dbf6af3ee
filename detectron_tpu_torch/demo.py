"""Demo: run a detector on image files and write visualizations.

    python -m detectron_tpu_torch.demo --config configs/retinanet_r50_fpn_coco.yaml \\
        [--images a.jpg b.jpg] [--out build/demo] [--no-restore] [--cfg key=value ...]

Any model of the zoo: Mask R-CNN draws boxes and masks; Faster R-CNN,
RetinaNet and R-FCN (``configs/rfcn_r50_coco.yaml``) draw boxes.
The port of the root ``demo.py``: weights from the latest checkpoint in
``output_dir`` (``train/checkpoint.py::restore_params``; ``--no-restore``:
the random ones of ``Detector.init``), each image resized and normalized
as the eval pipeline does, ``predict_fn`` on the card (``--device cpu``
for the CPU), boxes mapped back to the image, masks pasted, everything
drawn (``utils/visualize.py``) and written. Without ``--images`` it runs
on two synthetic images (``data.synthetic.make_batch``). Reading
``--images`` needs ``cv2`` (imported then); the output is always a PNG
written by :func:`write_png` (zlib, no codec library): the same pixels
as ``demo.py``'s ``cv2.imwrite``, another encoder, ``.png`` for the
name's extension.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.coco import import_cv2
from detectron_tpu_torch.data.synthetic import make_batch
from detectron_tpu_torch.data.transforms import preprocess_example
from detectron_tpu_torch.models.mask_rcnn import paste_masks_numpy
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.utils.visualize import draw_detections


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--cfg", nargs="*", default=[])
    ap.add_argument("--images", nargs="*", default=[])
    ap.add_argument("--out", default=os.path.join("build", "demo"))
    ap.add_argument("--no-restore", action="store_true")
    ap.add_argument("--score-threshold", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="default: the card")
    return ap.parse_args(argv)


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb [H, W, 3]`` uint8: one IHDR, one zlib IDAT
    of unfiltered rows, IEND."""
    h, w = rgb.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_images(paths) -> list[tuple[str, np.ndarray]]:
    """``(name, RGB uint8)`` of each file, decoded by cv2."""
    cv2 = import_cv2("demo --images")
    raws = []
    for path in paths:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        raws.append((os.path.basename(path), img[:, :, ::-1]))
    return raws


def synthetic_images(cfg) -> list[tuple[str, np.ndarray]]:
    """Two seeded synthetic images, de-normalized to uint8 RGB."""
    b = make_batch(np.random.RandomState(0), 2, cfg.data.image_size, cfg.model.num_classes)
    mean = np.asarray(cfg.data.pixel_mean)
    std = np.asarray(cfg.data.pixel_std)
    return [(f"synthetic_{i}.png", np.clip(b["image"][i] * std + mean, 0, 255).astype(np.uint8))
            for i in range(2)]


def run(args) -> list[tuple[str, int]]:
    """Writes one visualization an image into ``args.out``; returns
    ``(path, detections drawn)`` for each."""
    cfg = get_config(args.config, args.cfg)
    det = build_detector(cfg, device=args.device)
    params = det.init(0)
    if not args.no_restore:
        params, step = ckpt.restore_params(cfg.output_dir, params, det.device)
        if step is not None:
            print(f"restored step {step}")
    os.makedirs(args.out, exist_ok=True)
    raws = read_images(args.images) if args.images else synthetic_images(cfg)
    written = []
    for name, rgb in raws:
        ex = preprocess_example(rgb.astype(np.float32), np.zeros((0, 4), np.float32),
                                np.zeros((0,), np.int32), cfg, train=False)
        dets, masks = det.predict_fn(params, {"image": ex["image"][None],
                                              "image_hw": ex["image_hw"][None]})
        scale = float(ex["image_hw"][0]) / rgb.shape[0]
        boxes = dets.boxes[0].float().cpu().numpy() / max(scale, 1e-9)
        scores = dets.scores[0].float().cpu().numpy()
        classes = dets.classes[0].cpu().numpy()
        valid = dets.valid[0].cpu().numpy()
        full_masks = None
        if masks is not None:
            full_masks = paste_masks_numpy(masks[0].float().cpu().numpy(), boxes, valid,
                                           rgb.shape[:2], threshold=cfg.mask.paste_threshold)
        vis = draw_detections(rgb, boxes, scores, classes, valid=valid, masks=full_masks,
                              score_threshold=args.score_threshold)
        out_path = os.path.join(args.out, os.path.splitext(name)[0] + ".png")
        write_png(out_path, vis)
        n = int((valid & (scores >= args.score_threshold)).sum())
        print(f"{name}: {n} detections >= {args.score_threshold} -> {out_path}", flush=True)
        written.append((out_path, n))
    return written


def main(argv=None):
    with torch.no_grad():
        run(parse_args(argv))


if __name__ == "__main__":
    main()
