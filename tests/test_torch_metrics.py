"""``utils/metrics.py::MetricsWriter`` and ``utils/timer.py::Timer`` of the
port against the JAX package's: the same JSONL records (``step``,
``time``, then the scalars as floats; ``time`` aside), TensorBoard scalars
beside them when ``torch.utils.tensorboard`` imports, and the same timer
averages."""

import json
import time

import numpy as np
import pytest
import torch

from detectron_tpu.utils.metrics import MetricsWriter as JaxMetricsWriter
from detectron_tpu.utils.timer import Timer as JaxTimer
from detectron_tpu_torch.utils.metrics import MetricsWriter
from detectron_tpu_torch.utils.timer import Timer

SCALARS = [(1, {"loss_total": np.float32(2.5), "lr": 0.001, "img_per_sec": 3}),
           (2, {"loss_total": torch.tensor(1.25), "loss_cls": np.float64(0.5), "lr": 0.002}),
           (10, {"nan": float("nan")})]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_jsonl_records_equal_the_jax_writer(tmp_path):
    for cls, sub in ((JaxMetricsWriter, "jax"), (MetricsWriter, "port")):
        w = cls(str(tmp_path / sub), use_tensorboard=False)
        for step, scalars in SCALARS:
            w.write(step, scalars)
        w.close()
    want, got = records(tmp_path / "jax" / "metrics.jsonl"), records(
        tmp_path / "port" / "metrics.jsonl")
    assert len(got) == len(want) == len(SCALARS)
    for g, w in zip(got, want):
        assert list(g)[:2] == ["step", "time"] and abs(g.pop("time") - w.pop("time")) < 60
        assert json.dumps(g) == json.dumps(w)


def test_writer_appends(tmp_path):
    for _ in range(2):
        w = MetricsWriter(str(tmp_path), use_tensorboard=False)
        w.write(1, {"a": 1.0})
        w.close()
    assert [r["a"] for r in records(tmp_path / "metrics.jsonl")] == [1.0, 1.0]


def test_tensorboard_scalars(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    w = MetricsWriter(str(tmp_path))
    assert w.tb is not None
    w.write(3, {"loss_total": 1.5})
    w.write(4, {"loss_total": 0.5})
    w.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss_total")] == [(3, 1.5), (4, 0.5)]


def test_timer_averages_like_jax(monkeypatch):
    ticks = [0.0, 0.5, 1.0, 2.0, 2.0, 2.25, 5.0, 5.0]
    timers = []
    for cls in (JaxTimer, Timer):
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        t = cls()
        t.tic("step")
        assert t.toc("step") == 0.5
        t.tic("step")
        t.toc("step")
        t.tic("data")
        t.toc("data")
        t.tic()
        t.toc()
        timers.append(t)
    jax_t, port_t = timers
    assert port_t.average("step") == jax_t.average("step") == 0.75
    assert port_t.average("data") == 0.25
    assert port_t.summary() == jax_t.summary() == (
        "data: 250.0ms | default: 0.0ms | step: 750.0ms")
    assert port_t.average("never") == jax_t.average("never") == 0.0
