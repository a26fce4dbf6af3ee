"""Offline batch inference: ``Detector.predict_fn`` in a closed loop.

The mix gives the batch, how many distinct batches sit on the card (used
in turn), and the calls of the traced slice. Every call's outputs
(detections and mask probabilities) are copied to the host one call
deep, as the eval driver fetches them, and an image counts when its
outputs have reached the host. ``infer_img_s`` is those images over the
whole window, which ends when the last call's outputs are in.

For the check the window keeps, of the last call on each distinct batch,
the outputs and what the program's stages handed each other in that call
(``common.captured_stages``), and holds them to the plain reference stage
by stage (``harness/compare.py``).
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import common, compare, flops, inputs, trace
from benchmark.reference import model as ref

CHUNK = 4  # images the reference takes at once


def setup(run):
    cfg, det = common.build(run)
    params = common.make_params(run, det, common.calibration_batch(run))
    det.module.load_state_dict(params)
    batch = int(run.mix["batch"])
    data = inputs.coco_like_batches(run.seed, int(run.mix["distinct_batches"]), batch,
                                    run.settings, run.device)
    feeds = [{"image": b["image"], "image_hw": b["image_hw"]} for b in data]
    state = {"det": det, "feeds": feeds, "params": common.to_host(params), "batch": batch}
    del params, data
    # warm-up: the window's own loop, every batch twice, so that the window
    # finds its shapes built and its held outputs' memory in the pool
    drive(state, lambda n, t: n < 2 * len(feeds), common.Timer())
    run.stats["flops_per_call"] = batch * flops.image_flops(run.settings, train=False)
    return state


def drive(state, more, issue) -> tuple[int, int]:
    """The loop: a call on the next batch, then the wait for the call
    before it, while ``more(calls, seconds)``; then the last call's wait.
    Keeps each batch's last outputs and stages in ``state["kept"]``.
    ``(calls, images whose outputs hold a value that is not finite)``."""
    feeds, kept, slot = state["feeds"], state.setdefault("kept", {}), {}
    pending, calls, failed = None, 0, 0

    def finish(call):
        i, fetch, stages = call
        kept[i] = {"out": common.finish_fetch(fetch), "stages": stages}
        return common.nonfinite(kept[i]["out"])

    with common.captured_stages(slot):
        t0 = time.perf_counter()
        while more(calls, time.perf_counter() - t0):
            i = calls % len(feeds)
            with issue.time():
                dets, masks = state["det"].predict_fn(None, feeds[i])
            call = (i, common.start_fetch(dets, masks), dict(slot))
            if pending is not None:
                failed += finish(pending)
            pending, calls = call, calls + 1
        failed += finish(pending)
    return calls, failed


def window(run, state) -> dict:
    issue = common.Timer()
    common.sync(run.device)
    t0 = time.perf_counter()
    calls, failed = drive(state, lambda n, t: t < run.seconds, issue)
    elapsed = time.perf_counter() - t0
    batch = state["batch"]
    run.stats.update(issue_s=issue.samples, calls=calls, elapsed_s=elapsed,
                     attempted=calls * batch, failed=failed)
    return {"infer_img_s": calls * batch / elapsed}


def _step(state, i):
    dets, masks = state["det"].predict_fn(None, state["feeds"][i % len(state["feeds"])])
    return common.start_fetch(dets, masks)


def traced_slice(run, state):
    pending = []

    def step(i):  # as the window: issue a call, then wait for the one before
        with torch.profiler.record_function("predict_fn"):
            fetch = _step(state, i)
        with torch.profiler.record_function("fetch"):
            if pending:
                common.finish_fetch(pending.pop())
        pending.append(fetch)

    tr = trace.traced(step, int(run.mix["trace_calls"]), spans=("predict_fn", "fetch"))
    common.finish_fetch(pending.pop())
    run.stats["trace"] = tr
    run.stats["trace_calls"] = int(run.mix["trace_calls"])
    record = {}
    with common.captured_kernel_inputs(record):
        common.finish_fetch(_step(state, 0))
    run.stats.update(common.kernel_bounds(record))
    return tr


def release(run, state) -> dict:
    kept = {"kept": {i: {"out": k["out"], "stages": common.stages_to(k["stages"], "cpu")}
                     for i, k in state.pop("kept").items()},
            "feeds": [{k: v.cpu() for k, v in f.items()} for f in state["feeds"]],
            "params": state["params"]}
    state.clear()
    return kept


def program_side(kept_call: dict, rows: slice, device) -> dict:
    """The program's stages on images ``rows`` of one kept call: what its
    stages handed each other, and its fetched outputs, on ``device``."""
    cut = lambda t: t[rows].to(device)
    stages = kept_call["stages"]
    out = {k: torch.as_tensor(v[rows], device=device) for k, v in kept_call["out"].items()}
    return {"rpn": tuple([cut(t) for t in part] for part in stages["rpn"]),
            "proposals": tuple(cut(t) for t in stages["proposals"]),
            "box": tuple(cut(t) for t in stages["box"]),
            "dets": ref.Detections(out["boxes"], out["scores"], out["classes"],
                                   out["valid"].bool()),
            "masks": out["masks"]}


def numbers(run, kept, side_of) -> dict:
    """The comparison numbers of every kept batch, ``CHUNK`` images at a
    time: ``side_of(i, rows, images, image_hw)`` gives the stages of the
    path under test, which the fp32 reference follows."""
    params = {k: v.to(run.device) for k, v in kept["params"].items()}
    s = run.settings
    parts = []
    for i in sorted(kept["kept"]):
        feed = kept["feeds"][i]
        for r in range(0, feed["image"].shape[0], CHUNK):
            rows = slice(r, r + CHUNK)
            images, hw = feed["image"][rows].to(run.device), feed["image_hw"][rows].to(run.device)
            side = side_of(i, rows, images, hw)
            parts.append(compare.inference_numbers(
                side, ref.follow(params, s, images, hw, side), s["bbox_reg_weights"]))
            del side
    return compare.merge_inference(parts)


def check(run, kept) -> dict:
    return numbers(run, kept, lambda i, rows, images, hw:
                   program_side(kept["kept"][i], rows, run.device))


def calibrate(run, kept) -> dict:
    """The program's numbers and the control's: the plain reference in
    the mix's ``control`` precision put in the program's place on the same
    batches."""
    params = {k: v.to(run.device) for k, v in kept["params"].items()}
    control = numbers(run, kept, lambda i, rows, images, hw:
                      ref.predict(params, run.settings, images, hw, run.mix["control"]))
    return {"program": check(run, kept), "control": control}
