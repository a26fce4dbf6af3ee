"""What the loops share: the run's context, the weights, the fetch of a
call's outputs, and the capture of the kernels' inputs for the
rooflines."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from benchmark.harness import inputs, program, weights


class Run:
    """One run of one cell: its files, arguments, and what the loop
    records for the metrics and the check (``stats``)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.settings = program.settings(cell)
        self.mix = cell.mix
        self.stats: dict = {}

    def log(self, *args) -> None:
        print(f"[{self.cell.name}]", *args, file=sys.stderr, flush=True)


def build(run):
    """The program's config and detector for ``run``'s cell."""
    cfg = program.program_config(run.cell)
    return cfg, program.build_detector(cfg, run.device)


# images that set the frozen statistics and the logits' scales, as
# ``bench.py::calibrate_frozen_bn`` sets them from its first batch
CALIBRATION_IMAGES = 2


def calibration_batch(run) -> dict:
    """The images that set the frozen statistics and the logits' scales: a
    seeded COCO-like batch of ``CALIBRATION_IMAGES``."""
    return inputs.coco_like_batches(run.seed, 1, CALIBRATION_IMAGES, run.settings,
                                    run.device)[0]


def make_params(run, det, calib: dict) -> dict:
    """Weights from the seed: drawn, frozen statistics and (where the
    configuration asks for it) the logits calibrated by the reference."""
    params = weights.random_params(program.parameter_shapes(det), run.seed, run.device,
                                   run.cell.config.get("residual_gamma", 1.0))
    weights.calibrate_frozen_bn(params, run.settings, calib["image"])
    if "logits" in run.cell.config:
        weights.calibrate_logits(params, run.settings, calib["image"], calib["image_hw"],
                                 run.cell.config["logits"])
    return params


def to_host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def tf32_off():
    """Float32 matmuls and convolutions in float32 on the card while the
    block runs: the reference's numerics."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def start_fetch(dets, masks):
    """Queues the copy of one predict call's outputs into pinned host
    memory behind the call's own work: ``(host tensors, event)``. bf16
    outputs are cast to float32 on the card first (exact). On the CPU
    there is nothing to wait for (no event)."""
    fields = [dets.boxes, dets.scores, dets.classes, dets.valid, masks]
    host = [(t.float() if t.dtype == torch.bfloat16 else t).to("cpu", non_blocking=True)
            for t in fields]
    if not dets.boxes.is_cuda:
        return host, None
    done = torch.cuda.Event()
    done.record()
    return host, done


def finish_fetch(fetch) -> dict:
    """Waits for a fetch; its outputs as numpy arrays."""
    host, done = fetch
    if done is not None:
        done.synchronize()
    names = ("boxes", "scores", "classes", "valid", "masks")
    return {k: t.numpy() for k, t in zip(names, host)}


def nonfinite(out: dict) -> int:
    """Images whose outputs hold a value that is not finite."""
    bad = ~np.isfinite(out["scores"]).all(1) | ~np.isfinite(out["boxes"]).all((1, 2))
    return int(bad.sum())


@contextmanager
def captured_kernel_inputs(record: dict):
    """Records the inputs that the program hands K1 (its greedy walk) and
    K2 (its multilevel RoIAlign) while the block runs, into
    ``record["k1"]`` and ``record["k2"]``."""
    from detectron_tpu_torch.models import faster_rcnn
    from detectron_tpu_torch.ops import nms

    walk, align = nms.greedy_keep, faster_rcnn.multilevel_roi_align
    record.setdefault("k1", [])
    record.setdefault("k2", [])

    def k1(sboxes, svalid, thresh, offset=0.0, max_keep=None):
        record["k1"].append((sboxes.detach().clone(), svalid.clone(), float(thresh), max_keep))
        return walk(sboxes, svalid, thresh, offset, max_keep)

    def k2(features, rois, strides, output_size=7, sampling_ratio=2, max_span=None, **kw):
        record["k2"].append(([f.detach() for f in features], rois.detach().clone(),
                             tuple(strides), int(output_size), int(sampling_ratio), max_span))
        return align(features, rois, strides, output_size=output_size,
                     sampling_ratio=sampling_ratio, max_span=max_span, **kw)

    nms.greedy_keep, faster_rcnn.multilevel_roi_align = k1, k2
    try:
        yield record
    finally:
        nms.greedy_keep, faster_rcnn.multilevel_roi_align = walk, align


@contextmanager
def captured_stages(slot: dict):
    """While the block runs, ``slot`` holds what the program's latest
    forward handed from stage to stage: its RPN outputs (``"rpn"``, the
    objectness and deltas a level), its proposals (``"proposals"``, boxes
    and validity) and, in inference, its box head's class logits and box
    deltas (``"box"``). They are the program's own tensors, held and not
    copied: nothing is synchronised or launched."""
    from detectron_tpu_torch.models import faster_rcnn

    plain_proposals, plain_inference = faster_rcnn.proposals_from_rpn, \
        faster_rcnn.fastrcnn_inference

    def proposals(scores_pl, deltas_pl, anchors_pl, image_hw, cfg, train=False):
        out = plain_proposals(scores_pl, deltas_pl, anchors_pl, image_hw, cfg, train=train)
        slot["rpn"] = (list(scores_pl), list(deltas_pl))
        slot["proposals"] = (out.boxes, out.valid)
        return out

    def inference(cls_logits, reg, rois, roi_valid, image_hw, cfg):
        slot["box"] = (cls_logits, reg)
        return plain_inference(cls_logits, reg, rois, roi_valid, image_hw, cfg)

    faster_rcnn.proposals_from_rpn, faster_rcnn.fastrcnn_inference = proposals, inference
    try:
        yield slot
    finally:
        faster_rcnn.proposals_from_rpn, faster_rcnn.fastrcnn_inference = \
            plain_proposals, plain_inference


def stages_to(stages: dict, device) -> dict:
    """``stages`` (nested tuples and lists of tensors) on ``device``."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device)
        parts = [move(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)

    return {k: move(v) for k, v in stages.items()}


def kernel_bounds(record: dict) -> dict:
    """K1's and K2's bound seconds for the recorded inputs (one call's)."""
    from benchmark.harness import roofline

    k1 = sum(roofline.k1_bound_s(b, v, t, m) for b, v, t, m in record.get("k1", []))
    k2 = sum(roofline.k2_bound_s(f, r, st, p, s, span)
             for f, r, st, p, s, span in record.get("k2", []))
    return {"k1_bound_s": k1, "k2_bound_s": k2}


class Timer:
    """Host seconds of each call of a part, in a list."""

    def __init__(self):
        self.samples = []

    @contextmanager
    def time(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.samples.append(time.perf_counter() - t)
