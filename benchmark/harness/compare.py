"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Inference (every image of the kept calls compared). The program's stages
hand each other their outputs within one call: the RPN its objectness and
deltas to the proposal stage, that its proposals to the box head, the box
head its logits and deltas to the post-processing, that its detections to
the mask head. The reference follows them stage by stage on the very
inputs the program's stages took (``reference/model.py::follow``), so
that which of two near-equal candidates rounding keeps in one stage does
not enter the next one's numbers:

* ``rpn_gap``: the widest gap of the program's objectness logits and RPN
  deltas from the reference's on the same images, over the reference's
  spread of each (the backbone, the FPN and the RPN head);
* ``proposal_mismatch``: proposal slots where the reference's proposal
  stage (top-k, decode, clip, NMS, cross-level top-k) on the program's
  RPN outputs gives another box or validity (exact: the anchors, the
  decode and K1 in the RPN);
* ``score_gap``: the widest gap between the program's class probabilities
  and the reference's box head's on the program's proposals, over every
  valid RoI and class (RoIAlign at 7x7, K2, and the box head);
* ``box_gap``: the same of the box deltas, each over its weight (a share
  of the RoI's size, or of its log-size): the box regression;
* ``detection_mismatch``: detection slots where the reference's
  post-processing (softmax, per-class decode, clip, threshold, top
  candidates, class-aware NMS) on the program's box-head outputs gives
  another box, score, class or validity than the program's outputs
  (exact: the decode and K1 both ways, suppressing too much or too
  little);
* ``mask_gap``: the widest gap between a detection's mask probability and
  the reference's mask head's on the same box and class (RoIAlign at
  14x14, K2, and the mask head).

Training (the mix's ``checked_steps`` first steps; the reference samples its RoIs from the
program's proposals of each step, so that the two sides train on the same
RoIs): ``loss_gap``, the largest relative gap of a step's total loss;
``grad_gap``, the worst leaf's gap between the norms of the first step's
momentum buffer (the gradient as SGD takes it, weight decay added), and
``grad_gap_median``, the median leaf's; ``update_gap`` and
``update_gap_median``, the same of the parameters' change over those
steps. A leaf's gap is relative to the larger of its reference norm and
the median leaf's; leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change (they move by round-off).
Which of these a cell compares, its mix's ``limits`` say.
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_GRAD = 1e-3
INFERENCE_MAX = ("rpn_gap", "score_gap", "box_gap", "mask_gap")
INFERENCE_SUM = ("proposal_mismatch", "detection_mismatch")


def _spread_gap(side, ref) -> float:
    """The widest gap of ``side`` from ``ref`` (lists of tensors), over
    ``ref``'s standard deviation."""
    r = torch.cat([t.float().reshape(-1) for t in ref])
    s = torch.cat([t.float().reshape(-1) for t in side])
    return float((s - r).abs().max() / r.std().clamp_min(1e-30))


def inference_numbers(side: dict, ref: dict, weights) -> dict:
    """``side``: a path's stages as ``reference/model.py::predict`` gives
    them; ``ref``: the reference following them (``follow``); ``weights``:
    the box deltas' weights. Tensors on one device."""
    scores, deltas = side["rpn"]
    rpn_gap = max(_spread_gap(scores, ref["rpn"][0]), _spread_gap(deltas, ref["rpn"][1]))
    boxes, valid = side["proposals"]
    want_boxes, want_valid = ref["proposals"]
    same = (want_valid == valid) & (want_boxes == boxes).all(-1)
    proposal_mismatch = int((~same).sum())
    cls_logits, reg = side["box"]
    ref_logits, ref_reg = ref["box"]
    probs = torch.softmax(cls_logits.float(), -1)[valid]
    score_gap = float((probs - torch.softmax(ref_logits.float(), -1)[valid]).abs().max()) \
        if probs.numel() else 0.0
    w = torch.tensor(weights, dtype=torch.float32, device=reg.device)
    fg = (reg[:, :, 1:].float() - ref_reg[:, :, 1:].float()) / w
    box_gap = float(fg[valid].abs().max()) if probs.numel() else 0.0
    d, want = side["dets"], ref["dets"]
    same = ((d.valid == want.valid) & (d.classes.long() == want.classes.long())
            & (d.scores.float() == want.scores.float()) & (d.boxes == want.boxes).all(-1))
    dv = d.valid.bool()
    mask_gap = float((side["masks"].float() - ref["masks"])[dv].abs().max()) \
        if dv.any() else 0.0
    return {"rpn_gap": rpn_gap, "proposal_mismatch": proposal_mismatch,
            "score_gap": score_gap, "box_gap": box_gap,
            "detection_mismatch": int((~same).sum()), "mask_gap": mask_gap}


def merge_inference(parts: list[dict]) -> dict:
    """The numbers of several blocks of images: gaps by their widest,
    mismatches summed."""
    out = {k: max(p[k] for p in parts) for k in INFERENCE_MAX}
    out.update({k: sum(p[k] for p in parts) for k in INFERENCE_SUM})
    return out


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """``|norm(prog) - norm(ref)| / max(norm(ref), median)`` of each leaf of
    ``names``, the median taken over the reference's leaf norms."""
    pn, rn = leaf_norms({k: prog[k] for k in names}), leaf_norms({k: ref[k] for k in names})
    median = float(np.median([rn[k] for k in names]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in names}


def worst_leaf_gap(prog: dict, ref: dict, names) -> tuple[float, str, float]:
    """The largest leaf gap over the leaves ``names``, that leaf's name, and
    the median leaf gap."""
    names = list(names)
    if not names:
        return 0.0, "", 0.0
    gaps = leaf_gaps(prog, ref, names)
    worst = max(names, key=gaps.get)
    return gaps[worst], worst, float(np.median(list(gaps.values())))


def training_numbers(prog_losses, ref_losses, prog_buf1: dict, ref_buf1: dict, start: dict,
                     prog_end: dict, ref_end: dict) -> dict:
    """Losses a step (lists of floats), first momentum buffers, and the
    parameters at the start and after the last compared step (dicts of
    tensors on one device, the trainable leaves)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    names = sorted(ref_buf1)
    grad_gap, grad_leaf, grad_median = worst_leaf_gap(prog_buf1, ref_buf1, names)
    gnorm = leaf_norms(ref_buf1)
    median = float(np.median(list(gnorm.values())))
    moving = [k for k in names if gnorm[k] >= ZERO_GRAD * median]
    prog_change = {k: prog_end[k] - start[k] for k in moving}
    ref_change = {k: ref_end[k] - start[k] for k in moving}
    update_gap, update_leaf, update_median = worst_leaf_gap(prog_change, ref_change, moving)
    return {"loss_gap": float(loss_gap), "grad_gap": grad_gap, "update_gap": update_gap,
            "grad_gap_median": grad_median,
            "update_gap_median": update_median,
            "grad_leaf": grad_leaf, "update_leaf": update_leaf,
            "leaves_compared": len(moving), "leaves": len(names)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that have a
    limit; a number that is not finite fails."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
