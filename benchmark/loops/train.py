"""Training: ``train_step`` in a closed loop, SGD with momentum.

The mix gives the batch (and the learning rate that goes with it, among
its settings), how many distinct batches sit on the card with their
sampling draws (used in turn), how many of the first steps the check
compares, and the steps of the traced slice.

Set-up builds one train state and drives it through the first
``checked_steps`` steps with the window's own call, on distinct batches;
what those steps left (the losses, the first momentum buffers, the
parameters after the last) is kept on the host for the check, and the
same state goes on into the window. ``train_img_s`` is the images stepped
over the window, which ends in a synchronise; ``train_peak_gib`` the
run's peak of allocated device memory.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import common, compare, flops, inputs, roofline, trace
from benchmark.reference import model as ref

FORWARD_END = "mask: targets + align (K2) + head + loss"  # the forward's last mark


def trainable_names(det) -> list[str]:
    return [n for n, p in det.module.named_parameters() if p.requires_grad]


def anchor_count(settings) -> int:
    h, w = settings["canvas"]
    per_cell = len(settings["anchor_ratios"])
    return sum(-(-h // s) * -(-w // s) * per_cell for s in ref.RPN_STRIDES)


def make_draws(run, batch: int, n: int) -> list:
    """``n`` sets of a step's uniform draws on the card, from the seed."""
    from detectron_tpu_torch.models.faster_rcnn import TrainDraws

    from benchmark.harness.weights import generator

    g = generator(run.seed, 7, run.device)
    anchors = anchor_count(run.settings)
    cand = run.settings["post_nms_topk_train"] + run.settings["max_gt_boxes"]

    def draw(cols):
        return torch.rand((batch, cols), generator=g, device=run.device)

    return [TrainDraws(draw(anchors), draw(anchors), draw(cand), draw(cand)) for _ in range(n)]


def setup(run):
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg, det = common.build(run)
    batch = int(run.mix["batch"])
    data = inputs.coco_like_batches(run.seed, int(run.mix["distinct_batches"]), batch,
                                    run.settings, run.device)
    calib = {k: v[:common.CALIBRATION_IMAGES] for k, v in data[0].items()}
    params = common.make_params(run, det, calib)
    det.module.load_state_dict(params)
    names = trainable_names(det)
    state = create_train_state(cfg, det)
    draws = make_draws(run, batch, len(data))
    by_param = {p: n for n, p in det.module.named_parameters()}
    losses, buf1, proposals, slot = [], None, [], {}
    with common.captured_stages(slot):  # the checked steps, also the warm-up
        for i in range(int(run.mix["checked_steps"])):
            losses.append(train_step(state, data[i], draws=draws[i])["loss_total"])
            got = common.stages_to(slot, "cpu")
            proposals.append((*got["rpn"], *got["proposals"]))
            if i == 0:
                buf1 = {by_param[p]: s["momentum_buffer"].to("cpu", copy=True)
                        for p, s in state.optimizer.state.items()}
    named = dict(det.module.named_parameters())
    kept = {"params": common.to_host(params), "losses": [float(x) for x in losses],
            "buf1": buf1, "end": {n: named[n].detach().to("cpu", copy=True) for n in names},
            "names": names, "proposals": proposals}
    del params
    run.stats["flops_per_call"] = batch * flops.image_flops(run.settings, train=True)
    return {"det": det, "state": state, "data": data, "draws": draws, "batch": batch,
            "kept": kept, "step": int(run.mix["checked_steps"]), "train_step": train_step}


def _step(state, mark=None):
    k = state["step"] % len(state["data"])
    state["step"] += 1
    return state["train_step"](state["state"], state["data"][k], draws=state["draws"][k],
                               mark=mark)["loss_total"]


def window(run, state) -> dict:
    issue = common.Timer()
    marks = []

    def mark(stage):
        if stage in (FORWARD_END, "backward"):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    bad = torch.zeros((), dtype=torch.int64, device=run.device)
    steps = 0
    common.sync(run.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        with issue.time():
            loss = _step(state, mark if run.trace else None)
        bad += (~torch.isfinite(loss)).to(torch.int64)
        steps += 1
    common.sync(run.device)
    elapsed = time.perf_counter() - t0
    backward_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(0, len(marks) - 1, 2)]
    run.stats.update(issue_s=issue.samples, calls=steps, elapsed_s=elapsed,
                     attempted=steps * state["batch"], failed=int(bad) * state["batch"],
                     backward_ms=backward_ms)
    return {"train_img_s": steps * state["batch"] / elapsed}


def traced_slice(run, state):
    def step(i):
        with torch.profiler.record_function("train_step"):
            _step(state)

    calls = int(run.mix["trace_calls"])
    tr = trace.traced(step, calls, spans=("train_step",))
    run.stats["trace"] = tr
    run.stats["trace_calls"] = calls
    s = run.settings
    h, w = s["canvas"]
    level_hw = [(-(-h // st), -(-w // st)) for st in ref.ROI_STRIDES]
    fg = max(int(s["roi_batch_per_image"] * s["roi_positive_fraction"]), 1)
    elem = 2 if s["dtype"] == "bfloat16" else 4
    b = state["batch"]
    run.stats["k3_bound_s"] = (
        roofline.k3_bound_s(b, s["roi_batch_per_image"], s["pool_size"], s["fpn_channels"],
                            level_hw, s["sampling_ratio"], elem)
        + roofline.k3_bound_s(b, fg, s["mask_pool_size"], s["fpn_channels"], level_hw,
                              s["sampling_ratio"], elem))
    return tr


def release(run, state) -> dict:
    kept = state["kept"]
    kept["data"] = state["data"]
    kept["draws"] = [ref.TrainDraws(*d) for d in state["draws"]]
    state.clear()
    return kept


def reference_side(run, kept, numerics: str = "fp32", rows=None):
    """``(losses, first momentum buffers, parameters after)`` of the
    reference's first ``checked_steps`` steps from the program's start, on
    the same batches and draws (or their ``rows``), sampling its RoIs from
    the program's proposals of each step; on the host."""
    steps = int(run.mix["checked_steps"])
    rows = rows or slice(None)
    params = {k: v.to(run.device) for k, v in kept["params"].items()}
    data = [{k: v[rows] for k, v in d.items()} for d in kept["data"][:steps]]
    draws = [ref.TrainDraws(*(x[rows] for x in d)) for d in kept["draws"][:steps]]
    props = [(b[rows].to(run.device), v[rows].to(run.device))
             if b.shape[0] == d["image"].shape[0] else None  # a program that lost rows
             for (_, _, b, v), d in zip(kept["proposals"][:steps], kept["data"][:steps])]
    got = {"losses": []}

    def on_step(i, step_losses, p, buf):
        got["losses"].append(step_losses["loss_total"])
        if i == 0:
            got["buf1"] = {n: buf[n].to("cpu", copy=True) for n in kept["names"]}

    end = ref.sgd_steps(params, run.settings, data, draws, numerics, on_step, props,
                        int(run.mix.get("reference_block", 0)) or None)
    return got["losses"], got["buf1"], {n: end[n].cpu() for n in kept["names"]}


def proposal_mismatch(run, kept) -> int:
    """Proposal slots of the checked steps where the reference's proposal
    stage (top-k, decode, clip, NMS, cross-level top-k), run on the
    program's own RPN outputs, gives another box or validity than the
    program's (K1 among them): an exact comparison."""
    wrong = 0
    for (scores, deltas, boxes, valid), batch in zip(kept["proposals"], kept["data"]):
        hw = batch["image_hw"]
        if boxes.shape[0] != hw.shape[0]:  # the program proposed for other rows
            wrong += hw.shape[0] * run.settings["post_nms_topk_train"]
            continue
        anchors = ref.anchors(run.settings, batch["image"].shape[1:3], run.device)
        want_boxes, want_valid = ref.train_proposals(
            run.settings, [s.to(run.device) for s in scores], [d.to(run.device) for d in deltas],
            anchors, hw)
        same = (want_valid.cpu() == valid) & (want_boxes.cpu() == boxes).all(-1)
        wrong += int((~same).sum())
    return wrong


def numbers(kept, side, reference) -> dict:
    """The comparison numbers of ``side`` against ``reference``."""
    start = {n: kept["params"][n] for n in kept["names"]}
    return compare.training_numbers(side[0], reference[0], side[1], reference[1], start,
                                    side[2], reference[2])


def program_side(run, kept):
    steps = int(run.mix["checked_steps"])
    return kept["losses"][:steps], kept["buf1"], kept["end"]


def check(run, kept) -> dict:
    out = numbers(kept, program_side(run, kept), reference_side(run, kept))
    out["proposal_mismatch"] = proposal_mismatch(run, kept)
    return out


def calibrate(run, kept) -> dict:
    """The program's numbers, the control's (the reference one precision
    below, the mix's ``control``, in the program's place) and a fault's
    (the reference's step on half of each batch, its losses the mean over
    that half), all against the reference."""
    reference = reference_side(run, kept)
    half = slice(0, max(int(run.mix["batch"]) // 2, 1))
    program = numbers(kept, program_side(run, kept), reference)
    program["proposal_mismatch"] = proposal_mismatch(run, kept)
    return {"program": program,
            "control": numbers(kept, reference_side(run, kept, run.mix["control"]), reference),
            "half_batch": numbers(kept, reference_side(run, kept, rows=half), reference)}
