"""``utils/spans.py``: the stage spans of ``predict_fn`` and ``train_step``.

Config: Mask R-CNN R-50, 256x256, fpn_channels=32, num_classes=4, small
proposal counts, batch 2 of ``make_batch``, on the CPU. Under
``torch.profiler`` every stage leaves a record (name, parent, call) and a
``detectron/<name>`` range; outside one nothing is recorded, no range is
opened, and the outputs are bitwise those of a recorded call. The trunk
(``models/resnet.py``) spans each of its stages, ``res2`` to ``res5``,
inside the caller's stage, and a ResNeXt's each grouped 3x3 (``grouped
3x3``) inside its stage; a plain ResNet's 3x3 has no span. The RPN's
anchor matching (``anchor match``) is a span inside ``rpn targets+loss``.
"""

from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.synthetic import make_batch
from detectron_tpu_torch.models import resnet
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils import spans

OVERRIDES = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
             "data.image_size=[256, 256]", "rpn.pre_nms_topk_test=128",
             "rpn.post_nms_topk_test=32", "rpn.pre_nms_topk_train=128",
             "rpn.post_nms_topk_train=32", "roi.batch_per_image=32",
             "test.detections_per_image=10", "train.batch_size=2", "train.max_gt_boxes=8",
             "train.grad_clip_norm=1.0"]
PREDICT = ["backbone+fpn", "rpn head", "proposals (K1)", "box: align (K2) + head",
           "detections (K1)", "mask: align (K2) + head + select"]
TRUNK = ["res2", "res3", "res4", "res5"]
FORWARD = ["anchors+draws", "backbone+fpn", "rpn head", "rpn targets+loss", "proposals (K1)",
           "roi sampling", "box: align (K2) + head + loss",
           "mask: targets + align (K2) + head + loss"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on the machine's cores; PyTorch's
    default of one intra-op thread per core in each of them only makes
    the workers contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.take()
    yield
    spans.take()


@pytest.fixture(scope="module")
def model():
    cfg = get_config(None, OVERRIDES)
    det = build_detector(cfg, device="cpu")
    params = det.init(0)
    batch = make_batch(np.random.RandomState(0), 2, (256, 256), 4, max_gt=8)
    return cfg, det, params, batch


def new_state(model):
    cfg, det, params, _ = model
    return tstate.create_train_state(cfg, det, params)


def profiled(fn):
    """``fn()`` under the profiler (host activity): its result and the
    profiler's event names."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def predict(model):
    _, det, params, batch = model
    feed = {k: torch.as_tensor(batch[k]) for k in ("image", "image_hw")}
    return det.predict_fn(params, feed)


def test_predict_fn_leaves_its_stage_spans_under_the_profiler(model):
    (dets, masks), names = profiled(lambda: predict(model))
    recs = spans.take()
    top = [r for r in recs if r.parent in (None, "predict")]
    assert [r.name for r in top] == ["predict"] + PREDICT
    assert [r.parent for r in top] == [None] + ["predict"] * len(PREDICT)
    assert [(r.name, r.parent) for r in recs if r not in top] == [
        (n, "backbone+fpn") for n in TRUNK]
    assert len({r.call for r in recs}) == 1
    assert all(r.host_ms > 0 for r in recs)
    assert all(r.device_ms is None for r in recs)  # no card here
    root = recs[0].host_ms
    assert sum(r.host_ms for r in top[1:]) <= root
    backbone = next(r for r in recs if r.name == "backbone+fpn")
    assert sum(r.host_ms for r in recs if r.name in TRUNK) <= backbone.host_ms
    assert {spans.PREFIX + n for n in ["predict"] + PREDICT + TRUNK} <= names
    assert masks.shape == (2, 10, 28, 28)


def test_train_step_leaves_its_stage_spans_under_the_profiler(model):
    marks = []
    _, names = profiled(lambda: tstate.train_step(new_state(model), model[3], mark=marks.append))
    recs = spans.take()
    stages = FORWARD + ["backward", "optimizer"]
    top = [r for r in recs if r.parent in (None, "train_step")]
    assert [r.name for r in top] == ["train_step"] + stages
    assert [r.parent for r in top] == [None] + ["train_step"] * len(stages)
    assert [(r.name, r.parent) for r in recs if r not in top] == [
        (n, "backbone+fpn") for n in TRUNK] + [("anchor match", "rpn targets+loss")]
    assert len({r.call for r in recs}) == 1
    assert marks == stages  # each mark once, once the span has closed
    assert {spans.PREFIX + n for n in ["train_step"] + stages} <= names


def test_a_data_parallel_step_spans_its_all_reduce(model):
    grads = []
    profiled(lambda: tstate.train_step(new_state(model), model[3],
                                       reduce_grads=grads.append))
    recs = spans.take()
    assert [r.name for r in recs][-3:] == ["backward", "gradient all-reduce", "optimizer"]
    assert len(grads) == 1


def test_a_resnext_trunk_spans_its_stages_and_each_grouped_conv(monkeypatch):
    monkeypatch.setitem(resnet.TRUNKS, "resnext_tiny",
                        resnet.Trunk((1, 1, 2, 1), groups=8, width_per_group=4))
    cfg = get_config(None, OVERRIDES + ["model.backbone=resnext_tiny",
                                        "data.image_size=[128, 128]"])
    det = build_detector(cfg, device="cpu")
    batch = make_batch(np.random.RandomState(0), 1, (128, 128), 4, max_gt=8)
    feed = {k: torch.as_tensor(batch[k]) for k in ("image", "image_hw")}
    _, names = profiled(lambda: det.predict_fn(det.init(0), feed))
    recs = spans.take()
    trunk = [(r.name, r.parent) for r in recs if r.name in TRUNK or r.name == "grouped 3x3"]
    assert trunk == [("res2", "backbone+fpn"), ("grouped 3x3", "res2"),
                     ("res3", "backbone+fpn"), ("grouped 3x3", "res3"),
                     ("res4", "backbone+fpn"), ("grouped 3x3", "res4"), ("grouped 3x3", "res4"),
                     ("res5", "backbone+fpn"), ("grouped 3x3", "res5")]
    assert spans.PREFIX + "grouped 3x3" in names
    assert [r.name for r in recs if r.parent in (None, "predict")] == ["predict"] + PREDICT


def test_a_plain_resnet_spans_its_stages_and_no_conv():
    """Every ResNet path (R-FCN's C4 trunk runs three stages) spans its
    stages; a plain bottleneck's 3x3 has no span."""
    trunk = resnet.ResNet("resnet50")
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        profiled(lambda: trunk(x))
        recs = spans.take()
        assert [(r.name, r.parent) for r in recs] == [(n, None) for n in TRUNK]
        profiled(lambda: trunk(x, stages=3))
        assert [r.name for r in spans.take()] == TRUNK[:3]


def test_nothing_is_recorded_or_opened_outside_a_profiler(model, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} opened outside the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    predict(model)
    tstate.train_step(new_state(model), model[3], mark=lambda stage: None)
    assert spans.take() == []
    assert spans.span("a") is spans.span("b")  # no mark: one shared object


def test_recording_changes_no_output_loss_or_parameter(model):
    plain = predict(model)
    recorded, _ = profiled(lambda: predict(model))
    for a, b in zip((*plain[0], plain[1]), (*recorded[0], recorded[1])):
        assert torch.equal(a, b)
    out = []
    for record in (False, True):
        st = new_state(model)
        step = lambda: tstate.train_step(st, model[3])  # noqa: E731
        metrics = profiled(step)[0] if record else step()
        out.append((metrics, {n: p.detach().clone()
                              for n, p in st.detector.module.named_parameters()}))
    (m0, p0), (m1, p1) = out
    assert set(m0) == set(m1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the host's clock."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        self.t = len(order)
        order.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


order = []


def test_spans_nest_share_a_call_and_resolve_events_when_taken(monkeypatch):
    monkeypatch.setattr(spans, "_timed_on_device", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    order.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.span("root"):
                with spans.span("a"):
                    with spans.span("a.1"):
                        pass
                with spans.span("b"):
                    pass
    recs = spans.take()
    assert [(r.name, r.parent) for r in recs] == [
        ("root", None), ("a", "root"), ("a.1", "a"), ("b", "root")] * 2
    calls = [r.call for r in recs]
    assert calls[:4] == [calls[0]] * 4 and calls[4:] == [calls[4]] * 4 and calls[0] != calls[4]
    # events in order: root, a, a.1 in, a.1 out, a out, b in, b out, root out
    assert [r.device_ms for r in recs[:4]] == [7.0, 3.0, 1.0, 1.0]
    assert all(r.events is None for r in recs) and spans.take() == []


def test_the_buffer_keeps_the_last_calls_and_a_failed_stage_marks_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_calls", deque(maxlen=3))
    marks = []
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with spans.span(f"call {i}"):
                with spans.span("stage", marks.append):
                    pass
        with pytest.raises(ValueError):
            with spans.span("failing", marks.append):
                raise ValueError("stage failed")
        with spans.span("after", marks.append):
            pass
    recs = spans.take()
    # the last three calls: each outermost span is one
    assert [r.name for r in recs] == ["call 4", "stage", "failing", "after"]
    assert recs[-1].parent is None and recs[-2].parent is None  # the stack was unwound
    assert marks == ["stage"] * 5 + ["after"]
    # outside the profiler a mark is still called, and only on success
    with spans.span("quiet", marks.append):
        pass
    assert marks[-1] == "quiet" and spans.take() == []
