"""What the stage metrics share: the program's own spans of the traced
slice (``detectron_tpu_torch/utils/spans.py``), read where a span starts
and ends inside ``predict_fn`` and ``train_step``.

The program records its spans while torch's profiler records, so only
the traced slice leaves them. They are taken from the program once, on
the first read, and kept on the run for the other readers. A program
without spans (or a run without a traced slice) leaves none, and every
reader then returns None.

Each metric is the mean, over the slice's calls (one a root span), of
the named spans' milliseconds summed in each call: device milliseconds
from the stream reaching a span's entry event to its reaching the exit
event, so they include the device's idle time while the host issued the
stage; or host milliseconds between the span's entry and exit, which
run high by the profiler's cost per operation (the unperturbed host
total is ``issue_ms.*``).
"""

from __future__ import annotations

import statistics

PREDICT = "predict"  # predict_fn's root span
TRAIN = "train_step"  # train_step's root span
# the training forward's spans, the first to the last (faster_rcnn_train_forward)
TRAIN_FORWARD = ("anchors+draws", "backbone+fpn", "rpn head", "rpn targets+loss",
                 "proposals (K1)", "roi sampling", "box: align (K2) + head + loss",
                 "mask: targets + align (K2) + head + loss")


def records(run) -> list:
    """The program's span records of the traced slice (none without one)."""
    if "spans" not in run.stats:
        run.stats["spans"] = _take() if run.stats.get("trace") is not None else []
    return run.stats["spans"]


def _take() -> list:
    try:
        from detectron_tpu_torch.utils import spans
    except ImportError:  # a program without spans
        return []
    return spans.take()


def mean_ms(run, root: str, names, kind: str = "device"):
    """The mean over the calls under a root span ``root`` of the ``kind``
    ("device" or "host") milliseconds of the spans ``names`` in each call;
    None where no call holds one of them or a span has no such time."""
    recs = records(run)
    totals = {r.call: 0.0 for r in recs if r.parent is None and r.name == root}
    found = False
    for r in recs:
        if r.call in totals and r.parent is not None and r.name in names:
            ms = r.device_ms if kind == "device" else r.host_ms
            if ms is None:
                return None
            totals[r.call] += ms
            found = True
    return statistics.fmean(totals.values()) if found else None
