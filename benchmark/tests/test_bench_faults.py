"""A whole run with the harness's look for a card skipped, on the CPU at a
small size with the program in float32, and the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have,
and true without one."""

import time

import numpy as np
import pytest
import torch

import benchmark.run as bench_run
from benchmark.harness.spec import Cell
from benchmark.tests.tiny import spec, tiny_copy

LIMITS = {"rpn_gap": 0.01, "proposal_mismatch": 0, "score_gap": 0.01, "box_gap": 0.01,
          "detection_mismatch": 0, "mask_gap": 0.01, "grad_gap": 0.05, "update_gap": 0.05,
          "grad_gap_median": 0.01, "update_gap_median": 0.01}


def run_cell(tmp_path, workload):
    root = tiny_copy(tmp_path, dtype="float32", limits=LIMITS)
    cell = Cell(spec(), workload, root=root)
    return bench_run.execute(cell, 3000000023, 1.0, False, torch.device("cpu"),
                             time.perf_counter())


@pytest.fixture
def predict_fault(monkeypatch):
    from detectron_tpu_torch.models.zoo import Detector

    plain = Detector.predict_fn

    def plant(fault):
        def predict(self, params, batch):
            dets, masks = plain(self, params, batch)
            return fault(dets), masks

        monkeypatch.setattr(Detector, "predict_fn", predict)

    return plant


def half_batch_left_out(dets):
    half = dets.valid.shape[0] // 2 or 1
    valid = dets.valid.clone()
    valid[half:] = False
    return dets._replace(valid=valid)


def answer_altered(dets):
    scores = dets.scores.clone()
    scores[0, 0] = scores[0, 0] * 0.5  # one detection's score, where it is produced
    return dets._replace(scores=scores)


@pytest.mark.parametrize("workload", ["mrcnn_r50_bulk_b16", "mrcnn_r101_train_b16"])
def test_sound_run_is_correct(tmp_path, workload):
    result = run_cell(tmp_path, workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [half_batch_left_out, answer_altered])
def test_bulk_fault_is_not_correct(tmp_path, predict_fault, fault):
    predict_fault(fault)
    result = run_cell(tmp_path, "mrcnn_r50_bulk_b16")
    assert not result["correct"], result["checks"]


def test_bulk_nms_that_suppresses_too_much_is_not_correct(tmp_path, monkeypatch):
    from detectron_tpu_torch.models import faster_rcnn

    plain = faster_rcnn.class_aware_nms

    def nms(*args, **kwargs):  # K1 in the detections drops its last kept box
        idx, keep = plain(*args, **kwargs)
        last = keep.sum(-1, keepdim=True) - 1
        return idx, keep & (torch.arange(keep.shape[-1]) != last)

    monkeypatch.setattr(faster_rcnn, "class_aware_nms", nms)
    result = run_cell(tmp_path, "mrcnn_r50_bulk_b16")
    assert not result["correct"], result["checks"]
    assert result["checks"]["detection_mismatch"]["value"] > 0


def test_bulk_proposal_altered_is_not_correct(tmp_path, monkeypatch):
    from detectron_tpu_torch.models import faster_rcnn

    plain = faster_rcnn.generate_proposals

    def proposals(*args, **kwargs):  # one proposal moved where it is produced
        out = plain(*args, **kwargs)
        boxes = out.boxes.clone()
        boxes[0, 0] += 1.0
        return out._replace(boxes=boxes)

    monkeypatch.setattr(faster_rcnn, "generate_proposals", proposals)
    result = run_cell(tmp_path, "mrcnn_r50_bulk_b16")
    assert not result["correct"], result["checks"]
    assert result["checks"]["proposal_mismatch"]["value"] > 0


def test_train_step_that_leaves_the_state_is_not_correct(tmp_path, monkeypatch):
    from detectron_tpu_torch.train import state as train_state

    plain = train_state.train_step

    def step(state, batch, draws=None, mark=None, reduce_grads=None):
        before = {k: v.clone() for k, v in state.detector.module.state_dict().items()}
        out = plain(state, batch, draws=draws, mark=mark, reduce_grads=reduce_grads)
        state.detector.module.load_state_dict(before)
        return out

    monkeypatch.setattr(train_state, "train_step", step)
    result = run_cell(tmp_path, "mrcnn_r101_train_b16")
    assert not result["correct"], result["checks"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0, abs=1e-6)


def test_train_half_batch_is_not_correct(tmp_path, monkeypatch):
    from detectron_tpu_torch.models.zoo import Detector

    plain = Detector.loss_fn

    def loss_fn(self, params, batch, draws, mark=None):
        half = batch["image"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        draws = type(draws)(*(d[:half] for d in draws))
        return plain(self, params, batch, draws, mark=mark)

    monkeypatch.setattr(Detector, "loss_fn", loss_fn)
    result = run_cell(tmp_path, "mrcnn_r101_train_b16")
    assert not result["correct"], result["checks"]
    assert np.isfinite(result["checks"]["grad_gap"]["value"])
