"""Evaluation driver of the port, with the flags and output of ``eval.py``.

    python -m detectron_tpu_torch.eval.driver \\
        --config configs/mask_rcnn_r50_fpn_coco.yaml \\
        --cfg data.root=/data/coco output_dir=build/run [--limit 100] [--no-restore]

weights (``model.weights``, a torchvision backbone or full-detector
``.pth`` / ``.npz``, if set; then the latest checkpoint of ``output_dir``,
params only) -> the
threaded ``Loader`` over the val split -> ``predict_fn`` on the card ->
detections mapped back to original image coordinates -> fused mask paste +
RLE on the host (Mask R-CNN) -> the COCO (box, and segm with masks), VOC or
MR^-2 metrics ->
``output_dir/eval_results.json``. It runs on the card; the CPU is for
tests (``run(cfg, device="cpu")``).

The loop is one deep, as in ``eval.py``: batch k+1's predict call is
issued before batch k's outputs are consumed. On the card the call returns
before its work is done; the copies of its outputs to the host are queued
right behind it (``start_fetch``), and ``consume`` waits for those alone,
so the host's paste + RLE of batch k runs while the device computes batch
k+1. With a ``torch.distributed`` process group, each process evaluates a
disjoint stride of the split and process 0 gathers the records
(``merge_across_processes``) and writes the metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import record_function

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.loader import Loader, get_dataset
from detectron_tpu_torch.eval import evaluate_coco, evaluate_mr, evaluate_voc
from detectron_tpu_torch.models.mask_rcnn import paste_masks_rle
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.utils.torch_weights import maybe_load_pretrained

# the loop's range in a torch.profiler trace (chip_smoke.py reads the
# device's busy share over it)
LOOP_SPAN = "eval_loop"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--cfg", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--limit", type=int, default=0,
                    help="eval the first N images (per process with several)")
    ap.add_argument("--no-restore", action="store_true",
                    help="evaluate randomly initialized weights (smoke)")
    return ap.parse_args(argv)


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group, (0, 1) without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def merge_across_processes(gts, dts):
    """Every process's (gts, dts) records gathered onto each process, in
    rank order; a no-op without a process group. The records are ragged
    numpy / RLE structures, so they travel pickled (``all_gather_object``)."""
    _, count = process_index_count()
    if count == 1:
        return gts, dts
    gathered = [None] * count
    torch.distributed.all_gather_object(gathered, (gts, dts))
    all_gts, all_dts = [], []
    for g, d in gathered:
        all_gts.extend(g)
        all_dts.extend(d)
    return all_gts, all_dts


def upcast(t: torch.Tensor) -> torch.Tensor:
    """A bf16 output as float32 (exact), where it lies; numpy has no bf16."""
    return t.float() if t.dtype == torch.bfloat16 else t


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return upcast(x.detach()).cpu().numpy()
    return np.asarray(x)


def start_fetch(dets, masks):
    """Issues the copies of one predict call's outputs to host memory:
    ``(outputs, event)``. On the card the copies (into pinned memory) are
    queued on the stream right behind the call's own work, so waiting for
    ``event`` waits for this batch only. A plain ``.cpu()`` in ``consume``
    would be queued behind the next batch's work, which the loop issues
    first, and would wait for that too. bf16 outputs (scores, mask
    probabilities) are cast to float32 on the card first, in the same
    queue; the cast is exact, so the host holds the bf16 values themselves.
    Elsewhere the outputs are returned as they are, with no event."""
    fields = [dets.boxes, dets.scores, dets.classes, dets.valid]
    if masks is not None:
        fields.append(masks)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in fields):
        return fields, None
    host = [upcast(t).to("cpu", non_blocking=True) for t in fields]
    done = torch.cuda.Event()
    done.record()
    return host, done


def gt_record(ex, cfg, ds, hw, with_masks: bool) -> dict:
    """The evaluation record of one image's ground truth, as ``eval.py``
    builds it: crowd boxes appended as ignore regions; with masks, the real
    gts' RLEs then the crowd regions' own RLEs."""
    # VOC: all objects (difficult ones are matched but not counted by
    # evaluate_voc). CityPersons: evaluate_mr counts every row of "boxes"
    # as a positive and takes its ignore regions from "ignore_boxes".
    if cfg.data.dataset == "citypersons":
        g_boxes, g_classes = ex["boxes"], ex["classes"]
    else:
        g_boxes = ex.get("all_boxes", ex["boxes"])
        g_classes = ex.get("all_classes", ex["classes"])
    g_ignore = np.zeros(len(g_boxes), bool)
    # annotation (segmentation) areas for COCO's area buckets; None for
    # datasets without them (VOC -> box area)
    g_areas = ex.get("areas")
    if g_areas is not None and len(g_areas) != len(g_boxes):
        g_areas = None  # all_boxes superset without aligned areas
    crowd_boxes = ex.get("crowd_boxes")
    if crowd_boxes is not None and len(crowd_boxes):
        # crowd regions absorb detections without counting (COCO rule)
        g_boxes = np.concatenate([g_boxes, crowd_boxes])
        g_classes = np.concatenate([g_classes, ex["crowd_classes"]])
        g_ignore = np.concatenate([g_ignore, np.ones(len(crowd_boxes), bool)])
        if g_areas is not None:
            g_areas = np.concatenate([g_areas, ex["crowd_areas"]])
    g = {
        "boxes": g_boxes,
        "classes": g_classes,
        "ignore": g_ignore,
        "areas": g_areas,
        "difficult": ex.get("all_difficult", ex.get("difficult")),
        "ignore_boxes": ex.get("ignore_boxes"),
    }
    if with_masks and ex.get("polygons") is not None:
        # real gts first, then the crowd regions' own RLEs, so the COCO
        # crowd-absorb rule (intersection / det area) applies to segm too
        g["masks"] = [
            ds.segmentation_to_rle(p, hw) for p in ex["polygons"]
        ] + [
            ds.segmentation_to_rle(s, hw)
            for s in ex.get("crowd_segmentations", [])[: len(g_boxes) - len(ex["polygons"])]
        ]
    return g


def evaluate(cfg, gts, dts, ds) -> dict:
    """The metrics of the dataset's protocol; COCO adds ``segm_*`` keys when
    both sides have masks."""
    if cfg.data.dataset == "voc":
        return evaluate_voc(gts, dts, ds.num_classes,
                            use_07_metric=cfg.data.voc_use_07_metric)
    if cfg.data.dataset == "citypersons":
        return evaluate_mr(gts, dts)
    res = evaluate_coco(gts, dts, cfg.model.num_classes)
    if dts and dts[0].get("masks") is not None and gts[0].get("masks"):
        segm = evaluate_coco(gts, dts, cfg.model.num_classes, iou_type="segm")
        res.update({f"segm_{k}": v for k, v in segm.items() if k != "per_class"})
    return res


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The batch with ``image`` and ``image_hw`` as tensors on ``device``
    (copied from pinned memory without blocking the host on the card); the
    other arrays stay numpy."""
    out = dict(batch)
    for k in ("image", "image_hw"):
        t = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def run(cfg, dataset=None, limit: int = 0, restore: bool = True, device=None,
        predict=None) -> dict | None:
    """Evaluates ``cfg`` over ``dataset`` (default: ``cfg.data.val_split`` of
    ``cfg.data.dataset``), at most ``limit`` images (0: all); writes
    ``output_dir/eval_results.json`` and returns the metrics, with
    ``"timing"`` added: host seconds of the loop and of the evaluation, host
    milliseconds per batch of its parts (waiting for the loader, copying
    the inputs to the device, issuing the predict call, consuming the
    outputs: fetch, paste + RLE, gt records), and on the card the device
    span of each predict call (CUDA events around it).
    ``predict(params, batch) -> (Detections, masks | None)`` replaces the
    detector's ``predict_fn`` (the tests' oracle). Returns None on a process
    other than 0 of a ``torch.distributed`` group."""
    pidx, pcount = process_index_count()
    det = build_detector(cfg, device=device)
    params = det.init(0)
    if cfg.model.weights:
        params = maybe_load_pretrained(cfg, params)
        print(f"initialized from {cfg.model.weights}", flush=True)
    if restore:
        params, step = ckpt.restore_params(cfg.output_dir, params, det.device)
        if step is not None:
            print(f"restored step {step} from {cfg.output_dir}", flush=True)
    predict = predict or det.predict_fn
    ds = dataset if dataset is not None else get_dataset(cfg, cfg.data.val_split, train=False)
    loader = Loader(ds, cfg, train=False, process_shard=(pidx, pcount))
    on_card = det.device.type == "cuda"
    gts, dts = [], []
    # the loader's order is not deterministic (worker threads) and tails
    # are padded by repetition: gts pair with detections by image id
    seen_ids = set()
    limit = limit or len(ds)
    host_ms = defaultdict(float)
    device_ms = []

    def consume(ids, orig_hw, batch, events, outputs, done):
        # one batch's outputs on the host (waits for its device work)
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        boxes, scores, classes, valid = (to_numpy(x) for x in outputs[:4])
        valid = valid.astype(bool)
        masks_np = to_numpy(outputs[4]) if len(outputs) > 4 else None
        t1 = time.perf_counter()
        host_ms["fetch"] += (t1 - t0) * 1e3
        if events is not None:
            # a predict that left its outputs on the host queued no fetch to
            # wait for: the span's end event may not have been reached yet
            events[1].synchronize()
            device_ms.append(events[0].elapsed_time(events[1]))
        for i in range(len(ids)):
            if len(seen_ids) >= limit:
                break
            image_id = ids[i].item() if hasattr(ids[i], "item") else ids[i]
            if image_id in seen_ids:
                continue  # tail-padding duplicate
            seen_ids.add(image_id)
            # map from resized coords back to original image coords
            scale = batch["image_hw"][i][0] / orig_hw[i][0]
            v = valid[i]
            b = boxes[i] / max(scale, 1e-9)
            d = {
                "boxes": b[v],
                "scores": scores[i][v],
                "classes": classes[i][v],
                "image_id": ids[i],
            }
            hw_i = tuple(int(x) for x in orig_hw[i])
            ta = time.perf_counter()
            if masks_np is not None:
                # fused C++ paste + RLE: O(box area) per detection
                d["masks"] = paste_masks_rle(
                    masks_np[i][v], b[v], np.ones(int(v.sum()), bool), hw_i,
                    threshold=cfg.mask.paste_threshold,
                )
            tb = time.perf_counter()
            dts.append(d)
            ex = ds.example(ds.index_of(image_id))
            gts.append(gt_record(ex, cfg, ds, hw_i, masks_np is not None))
            host_ms["paste_rle"] += (tb - ta) * 1e3
            host_ms["gt"] += (time.perf_counter() - tb) * 1e3
        host_ms["consume"] += (time.perf_counter() - t0) * 1e3

    t_loop = time.perf_counter()
    batches = 0
    pending = None
    with record_function(LOOP_SPAN), contextlib.closing(iter(loader)) as batch_iter:
        while True:
            t0 = time.perf_counter()
            batch = next(batch_iter, None)
            host_ms["loader_wait"] += (time.perf_counter() - t0) * 1e3
            if batch is None:
                break
            if pending is not None:
                # consuming `pending` raises seen_ids to exactly this count:
                # a batch past the limit would be thrown away
                pend_ids = {i.item() if hasattr(i, "item") else i for i in pending[0]}
                if len(seen_ids | pend_ids) >= limit:
                    break
            elif len(seen_ids) >= limit:
                break
            ids = batch.pop("_image_id")
            orig_hw = batch.pop("_orig_hw")
            events = None
            if on_card:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            t0 = time.perf_counter()
            inputs = batch_to_device(batch, det.device)
            t1 = time.perf_counter()
            out = predict(params, inputs)
            if on_card:
                events[1].record()
            fetch = start_fetch(*out)
            host_ms["to_device"] += (t1 - t0) * 1e3
            host_ms["predict"] += (time.perf_counter() - t1) * 1e3
            batches += 1
            if pending is not None:
                consume(*pending)
            pending = (ids, orig_hw, batch, events, *fetch)
        if pending is not None:
            consume(*pending)
    loop_s = time.perf_counter() - t_loop

    gts, dts = merge_across_processes(gts, dts)
    if pidx != 0:
        return None  # metrics are computed and written once, on process 0
    t_eval = time.perf_counter()
    res = evaluate(cfg, gts, dts, ds)
    eval_s = time.perf_counter() - t_eval
    os.makedirs(cfg.output_dir, exist_ok=True)
    out_path = os.path.join(cfg.output_dir, "eval_results.json")

    def clean(v):  # NaN (e.g. an empty area bucket) is not valid strict JSON
        return None if isinstance(v, float) and v != v else v

    with open(out_path, "w") as f:
        json.dump({k: clean(v) for k, v in res.items() if k != "per_class"}, f, indent=2)
    print(json.dumps({k: clean(round(v, 4)) for k, v in res.items()
                      if isinstance(v, float)}, indent=2))
    print("wrote", out_path, flush=True)
    n = len(seen_ids)
    res["timing"] = {
        "images": n, "batches": batches, "loop_s": loop_s, "eval_s": eval_s,
        "img_per_s": n / loop_s if loop_s > 0 else float("nan"),
        # host milliseconds per batch consumed, and per image for the paste
        **{f"{k}_ms_per_batch": v / max(batches, 1) for k, v in host_ms.items()},
        "paste_rle_ms_per_image": host_ms["paste_rle"] / max(n, 1),
        "detections": int(sum(len(d["scores"]) for d in dts)),
        "device_ms_per_call": device_ms,
    }
    return res


def main(argv=None):
    args = parse_args(argv)
    run(get_config(args.config, args.cfg), limit=args.limit, restore=not args.no_restore)


if __name__ == "__main__":
    main()
