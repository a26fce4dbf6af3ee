"""Offline batch inference over a ResNeXt trunk: ``loops/bulk.py``'s closed
loop, fetch and kept stages, with this trunk's weights, FLOP count and
plain reference (``reference/resnext.py``, ``harness/resnext.py``).

The traced slice also records the summed bound of one call's grouped
3x3s (``grouped_conv_bound_s``), which ``grouped_conv_roofline.*`` reads
against the program's ``grouped 3x3`` spans.
"""

from __future__ import annotations

from benchmark.harness import common, compare, inputs, program
from benchmark.harness import resnext as rx
from benchmark.loops import bulk
from benchmark.reference import resnext as ref

CHUNK = bulk.CHUNK
drive, window, release, program_side = bulk.drive, bulk.window, bulk.release, bulk.program_side


def setup(run):
    cfg, det = common.build(run)
    params = rx.make_params(run, program.parameter_shapes(det), common.calibration_batch(run))
    det.module.load_state_dict(params)
    batch = int(run.mix["batch"])
    data = inputs.coco_like_batches(run.seed, int(run.mix["distinct_batches"]), batch,
                                    run.settings, run.device)
    feeds = [{"image": b["image"], "image_hw": b["image_hw"]} for b in data]
    state = {"det": det, "feeds": feeds, "params": common.to_host(params), "batch": batch}
    del params, data
    # warm-up: the window's own loop, every batch twice (loops/bulk.py)
    drive(state, lambda n, t: n < 2 * len(feeds), common.Timer())
    run.stats["flops_per_call"] = batch * rx.image_flops(run.settings, train=False)
    return state


def traced_slice(run, state):
    tr = bulk.traced_slice(run, state)
    elem = 2 if run.settings["dtype"] == "bfloat16" else 4
    run.stats["grouped_conv_bound_s"] = rx.grouped_conv_bound_s(
        run.settings["backbone"], run.settings["canvas"], state["batch"], elem)
    return tr


def numbers(run, kept, side_of) -> dict:
    """``loops/bulk.py::numbers`` with this trunk's reference following."""
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
    """The program's numbers and the control's (this trunk's reference in
    the mix's ``control`` precision in the program's place)."""
    params = {k: v.to(run.device) for k, v in kept["params"].items()}
    control = numbers(run, kept, lambda i, rows, images, hw:
                      ref.predict(params, run.settings, images, hw, run.mix["control"]))
    return {"program": check(run, kept), "control": control}
