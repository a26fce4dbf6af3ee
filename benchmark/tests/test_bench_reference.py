"""The plain reference against the port on the CPU at a small size, with
the port in float32: the same function, to float32's rounding."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import compare, inputs, weights
from benchmark.reference import model as ref
from benchmark.tests.tiny import BENCH, CANVAS, OVERRIDES

CPU = torch.device("cpu")


def detector_and_params(config, overrides, seed):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    c = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    s = {**c["settings"], **CANVAS, "dtype": "float32"}
    cfg = get_config(str(BENCH.parent / c["yaml"]),
                     c["overrides"] + ["model.dtype=float32"] + OVERRIDES + overrides)
    det = build_detector(cfg, device=CPU)
    calib = inputs.coco_like_batches(seed, 1, 2, s, CPU)[0]
    shapes = {k: tuple(v.shape) for k, v in det.module.state_dict().items()}
    p = weights.random_params(shapes, seed, CPU, c["residual_gamma"])
    weights.calibrate_frozen_bn(p, s, calib["image"])
    if "logits" in c:
        weights.calibrate_logits(p, s, calib["image"], calib["image_hw"], c["logits"])
    det.module.load_state_dict(p)
    return cfg, det, p, s


def test_predict_matches_the_port():
    from benchmark.harness import common
    from benchmark.loops.bulk import program_side

    cfg, det, p, s = detector_and_params("mask_rcnn_r50_fpn_bf16", [], 11)
    b = inputs.coco_like_batches(11, 1, 2, s, CPU)[0]
    slot = {}
    with common.captured_stages(slot):
        dets, masks = det.predict_fn(None, b)
    out = common.finish_fetch(common.start_fetch(dets, masks))
    side = program_side({"out": out, "stages": slot}, slice(None), CPU)
    n = compare.inference_numbers(side, ref.follow(p, s, b["image"], b["image_hw"], side),
                                  s["bbox_reg_weights"])
    assert int(dets.valid.sum()) == 200  # the slots fill
    assert n["proposal_mismatch"] == 0 and n["detection_mismatch"] == 0, n
    assert max(n["rpn_gap"], n["score_gap"], n["box_gap"], n["mask_gap"]) < 1e-3, n
    own = ref.predict(p, s, b["image"], b["image_hw"])  # the reference alone
    np.testing.assert_allclose(out["scores"][:, :20], own["dets"].scores[:, :20].numpy(),
                               atol=1e-3)


def test_training_steps_match_the_port():
    from detectron_tpu_torch.models.faster_rcnn import TrainDraws
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg, det, p, s = detector_and_params("mask_rcnn_r101_fpn_train_bf16",
                                         ["train.batch_size=2", "train.base_lr=0.0025"], 12)
    s.update(batch_size=2, base_lr=0.0025)
    data = inputs.coco_like_batches(12, 2, 2, s, CPU)
    g = torch.Generator().manual_seed(12)
    h, w = s["canvas"]
    anchors = sum(-(-h // t) * -(-w // t) * 3 for t in ref.RPN_STRIDES)
    cand = s["post_nms_topk_train"] + s["max_gt_boxes"]
    draws = [TrainDraws(*(torch.rand((2, n), generator=g) for n in (anchors, anchors, cand, cand)))
             for _ in data]
    names = [n for n, q in det.module.named_parameters() if q.requires_grad]
    by = {q: n for n, q in det.module.named_parameters()}
    state = create_train_state(cfg, det)
    losses, buf1 = [], None
    for i, batch in enumerate(data):
        losses.append(float(train_step(state, batch, draws=draws[i])["loss_total"]))
        if i == 0:
            buf1 = {by[q]: v["momentum_buffer"].clone() for q, v in state.optimizer.state.items()}
    got = {"losses": []}

    def on_step(i, step_losses, params, buf):
        got["losses"].append(step_losses["loss_total"])
        if i == 0:
            got["buf1"] = {n: buf[n].clone() for n in names}

    end = ref.sgd_steps(p, s, data, [ref.TrainDraws(*d) for d in draws], "fp32", on_step)
    assert sorted(got["buf1"]) == sorted(names)
    after = {n: q.detach() for n, q in det.module.named_parameters() if q.requires_grad}
    n = compare.training_numbers(losses, got["losses"], buf1, got["buf1"],
                                 {k: p[k] for k in names}, after, {k: end[k] for k in names})
    assert n["loss_gap"] < 2e-3
    assert n["grad_gap"] < 1e-2 and n["update_gap"] < 2e-2
    assert losses[0] == pytest.approx(got["losses"][0], rel=1e-3)
