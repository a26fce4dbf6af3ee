"""The stage metrics (``harness/stages.py`` and the ten readers that use it)
on a fake recorder: each returns the per-call mean of its spans, and None
where the run left no record. Both cells report all ten."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import common, stages
from benchmark.harness.spec import Cell
from benchmark.tests.tiny import spec
from detectron_tpu_torch.utils import spans

BULK, TRAIN = "mrcnn_r50_bulk_b16", "mrcnn_r101_train_b16"
PREDICT_STAGES = ("backbone+fpn", "rpn head", "proposals (K1)", "box: align (K2) + head",
                  "detections (K1)", "mask: align (K2) + head + select")
TRAIN_STAGES = stages.TRAIN_FORWARD + ("backward", "optimizer")
NEW = {BULK: ["backbone_fpn_ms.bulk", "rpn_ms.bulk", "box_ms.bulk", "mask_ms.bulk",
              "backbone_fpn_host_ms.bulk"],
       TRAIN: ["backbone_fpn_ms.train", "forward_ms.train", "optimizer_ms.train",
               "forward_host_ms.train", "backward_host_ms.train"]}


def fake_records(root, names, calls):
    """Records as the program's ``take`` gives them: in call ``c`` the
    ``i``-th stage took ``10 * (i + 1) + c`` ms on the device and a tenth
    of that on the host; the root spans the lot."""
    out = []
    for c in range(calls):
        out.append(SimpleNamespace(name=root, parent=None, call=c, host_ms=1e3,
                                   device_ms=1e3))
        out += [SimpleNamespace(name=n, parent=root, call=c, host_ms=(10 * (i + 1) + c) / 10,
                                device_ms=10 * (i + 1) + c) for i, n in enumerate(names)]
    return out


def expected(names, wanted, calls, scale=1.0):
    per_call = [sum(10 * (names.index(n) + 1) + c for n in wanted) for c in range(calls)]
    return scale * sum(per_call) / calls


def traced_run(cell, monkeypatch, records):
    monkeypatch.setattr(spans, "take", lambda: list(records))
    run = common.Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.stats["trace"] = object()  # a traced slice ran
    return run


WANTED = {
    "backbone_fpn_ms.bulk": (("backbone+fpn",), 1.0),
    "rpn_ms.bulk": (("rpn head", "proposals (K1)"), 1.0),
    "box_ms.bulk": (("box: align (K2) + head", "detections (K1)"), 1.0),
    "mask_ms.bulk": (("mask: align (K2) + head + select",), 1.0),
    "backbone_fpn_host_ms.bulk": (("backbone+fpn",), 0.1),
    "backbone_fpn_ms.train": (("backbone+fpn",), 1.0),
    "forward_ms.train": (stages.TRAIN_FORWARD, 1.0),
    "optimizer_ms.train": (("optimizer",), 1.0),
    "forward_host_ms.train": (stages.TRAIN_FORWARD, 0.1),
    "backward_host_ms.train": (("backward",), 0.1),
}


@pytest.mark.parametrize("cell_name,metric", [(c, m) for c, ms in NEW.items() for m in ms])
def test_each_reader_gives_the_per_call_mean_of_its_spans(monkeypatch, cell_name, metric):
    cell = Cell(spec(), cell_name)
    root, names = ((stages.PREDICT, PREDICT_STAGES) if cell_name == BULK
                   else (stages.TRAIN, TRAIN_STAGES))
    # another root's calls in the same buffer are not counted
    other = fake_records("other", names, 2)
    for r in other:
        r.call += 100
    run = traced_run(cell, monkeypatch, fake_records(root, names, 4) + other)
    wanted, scale = WANTED[metric]
    got = cell.metric_reader(metric).read(run)
    assert got == pytest.approx(expected(list(names), wanted, 4, scale))


@pytest.mark.parametrize("cell_name", [BULK, TRAIN])
def test_readers_return_none_without_records(monkeypatch, cell_name):
    cell = Cell(spec(), cell_name)
    for metric in NEW[cell_name]:
        reader = cell.metric_reader(metric)
        # a run without a traced slice: the program is not asked
        monkeypatch.setattr(spans, "take", lambda: pytest.fail("read without a trace"))
        assert reader.read(common.Run(cell, 1, 1.0, False, torch.device("cpu"))) is None
        # a traced slice whose program left no span (the parent's program)
        assert reader.read(traced_run(cell, monkeypatch, [])) is None


def test_device_readers_return_none_off_the_card(monkeypatch):
    cell = Cell(spec(), TRAIN)
    recs = fake_records(stages.TRAIN, TRAIN_STAGES, 2)
    for r in recs:
        r.device_ms = None
    run = traced_run(cell, monkeypatch, recs)
    assert cell.metric_reader("forward_ms.train").read(run) is None
    assert cell.metric_reader("backward_host_ms.train").read(run) == pytest.approx(
        expected(list(TRAIN_STAGES), ("backward",), 2, 0.1))


def test_the_spans_are_taken_once_for_every_reader(monkeypatch):
    cell = Cell(spec(), BULK)
    taken = []

    def take():
        taken.append(1)
        return fake_records(stages.PREDICT, PREDICT_STAGES, 3)

    monkeypatch.setattr(spans, "take", take)
    run = common.Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.stats["trace"] = object()
    values = [cell.metric_reader(m).read(run) for m in NEW[BULK]]
    assert len(taken) == 1 and all(v is not None for v in values)


def test_the_program_s_own_spans_feed_the_host_readers():
    """Real spans under the profiler, on the CPU: host milliseconds read,
    device milliseconds not measured."""
    cell = Cell(spec(), BULK)
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with spans.span(stages.PREDICT):
                for name in PREDICT_STAGES:
                    with spans.span(name):
                        torch.ones(64, 64) @ torch.ones(64, 64)
    run = common.Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.stats["trace"] = object()
    assert cell.metric_reader("backbone_fpn_host_ms.bulk").read(run) > 0
    assert cell.metric_reader("backbone_fpn_ms.bulk").read(run) is None


@pytest.mark.parametrize("cell_name", [BULK, TRAIN])
def test_both_cells_report_the_ten_stage_metrics(cell_name):
    per_layer = [m for m in Cell(spec(), cell_name).per_layer if m["source"] == "program_span"]
    names = [m["name"] for m in per_layer]
    assert names[-5:] == NEW[cell_name]
    new = [m for m in spec()["per_layer"] if m["name"] in NEW[BULK] + NEW[TRAIN]]
    assert len(new) == 10 and all(m["unit"] == "ms" and m["better"] == "lower" for m in new)
    assert {m["layer"] for m in new} == {"model stages", "host dispatch"}
