"""Stage spans: the port's one mechanism for timing the stages of a call.

``with span(name, mark):`` wraps one stage of ``Detector.predict_fn`` or
``train_step``. When the block ends without an exception it calls
``mark(name)``, if a ``mark`` is given: the stage's work has then been
issued (the callback contract of ``faster_rcnn_train_forward`` and
``train_step``).

Spans record only while torch's profiler records
(``torch._C._autograd._profiler_enabled()``). Off, a span costs that
check and the ``mark`` call: no event, no profiler range, and with no
``mark`` not even an object. On, a span

* opens ``torch.profiler.record_function("detectron/<name>")``, so that
  its host range lies in the profiler's timeline, on the clock of the
  device's activity;
* records a CUDA event on the current stream at entry and at exit (where
  CUDA is available);
* keeps a :class:`Record` of its name, its parent's name, its call (the
  sequence number of the outermost span around it, shared by every span
  of one call) and its host milliseconds.

A span never synchronises. :func:`take` resolves the events into device
milliseconds (from the stream reaching the entry event to its reaching
the exit event, so they include the device's idle time while the host
issued the stage), returns the finished records in the order the spans
were entered, and clears the buffer, which keeps the spans of the last
``MAX_CALLS`` calls. Spans nest on the thread that drives the model.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import torch

PREFIX = "detectron/"  # the profiler ranges' prefix, apart from any caller's range names
MAX_CALLS = 1000

_recording = torch._C._autograd._profiler_enabled


@dataclass
class Record:
    """One span: ``parent`` is None for the outermost span of a call;
    ``device_ms`` is None off the card and until :func:`take` reads it."""

    name: str
    parent: str | None
    call: int
    host_ms: float | None = None
    device_ms: float | None = None
    events: tuple | None = field(default=None, repr=False, compare=False)


_calls: deque = deque(maxlen=MAX_CALLS)  # each call's records, outermost first
_open: list = []  # (record, its call's list) of the spans open on this thread
_sequence = itertools.count()


def _timed_on_device() -> bool:
    return torch.cuda.is_available()


class _Marked:
    """A span while nothing records: the ``mark`` call alone."""

    __slots__ = ("name", "mark")

    def __init__(self, name, mark):
        self.name, self.mark = name, mark

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.mark is not None:
            self.mark(self.name)


_QUIET = _Marked(None, None)


class _Recorded:
    """A span while the profiler records."""

    __slots__ = ("record", "mark", "range", "t0")

    def __init__(self, name, mark):
        self.record = Record(name, None, -1)
        self.mark = mark

    def __enter__(self):
        rec = self.record
        if _open:
            parent, calls = _open[-1]
            rec.parent, rec.call = parent.name, parent.call
        else:
            rec.call, calls = next(_sequence), []
            _calls.append(calls)
        calls.append(rec)
        _open.append((rec, calls))
        self.range = torch.profiler.record_function(PREFIX + rec.name)
        self.range.__enter__()
        if _timed_on_device():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start,)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.record
        rec.host_ms = (time.perf_counter_ns() - self.t0) * 1e-6
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events += (end,)
        _open.pop()
        self.range.__exit__(exc_type, exc, tb)
        if exc_type is None and self.mark is not None:
            self.mark(rec.name)


def span(name: str, mark=None):
    """A context manager around one stage named ``name`` (module doc)."""
    if not _recording():
        return _QUIET if mark is None else _Marked(name, mark)
    return _Recorded(name, mark)


def take() -> list[Record]:
    """The finished spans' records, entry order, device milliseconds
    resolved (waiting for each span's exit event); the buffer is cleared."""
    out = [r for calls in _calls for r in calls if r.host_ms is not None]
    _calls.clear()
    for r in out:
        if r.events is not None:
            start, end = r.events
            end.synchronize()
            r.device_ms, r.events = start.elapsed_time(end), None
    return out
