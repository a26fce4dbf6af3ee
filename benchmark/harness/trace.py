"""A traced slice of a run: ``torch.profiler`` over a fixed number of the
loop's own calls, reduced to what the per-layer metrics read.

* ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the device, within the slice; ``window_s``: the slice's length.
* kernel time by name (each kernel's intervals summed), for the
  breakdown and the kernels' rooflines;
* the longest idle gaps on the device, each named by what the host was
  doing at its middle: the innermost harness span (``record_function``)
  and the innermost operator around that time.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Trace:
    """What a traced slice left: device intervals, kernel times, gaps."""

    def __init__(self, prof, t_start_us: float, t_end_us: float, wall_s: float, spans=()):
        events = prof.events()
        self.window_s = wall_s
        self.kernels = defaultdict(float)  # name -> seconds
        self.launches = defaultdict(int)
        device, host = [], []
        span_names = set(spans)
        for e in events:
            kind = e.device_type.name
            start, end = e.time_range.start, e.time_range.end
            if kind == "CUDA":
                if e.name in span_names or getattr(e, "is_user_annotation", False):
                    continue
                device.append((start, end))
                self.kernels[e.name] += (end - start) * 1e-6
                self.launches[e.name] += 1
            elif kind == "CPU" and not e.name.startswith("Activity Buffer"):
                host.append((start, end, e.name, e.name in span_names))
        lo = t_start_us if t_start_us is not None else min((s for s, _ in device), default=0.0)
        hi = t_end_us if t_end_us is not None else max((e for _, e in device), default=0.0)
        merged = []
        for s, e in sorted(device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        if hi > lo:
            self.window_s = (hi - lo) * 1e-6
        gaps = []
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                gaps.append((b - a, (a + b) / 2))
        gaps.sort(reverse=True)
        self.gaps = []
        for length, mid in gaps[:10]:
            around = [(s, e, n, is_span) for s, e, n, is_span in host if s <= mid <= e]
            span = min((x for x in around if x[3]), key=lambda x: x[1] - x[0], default=None)
            op = min((x for x in around if not x[3]), key=lambda x: x[1] - x[0], default=None)
            name = "/".join(x[2] for x in (span, op) if x is not None) or "host idle"
            self.gaps.append((name, length * 1e-6))

    def kernel_seconds(self, names) -> float:
        """Seconds the kernels whose names contain one of ``names`` ran."""
        return sum(t for k, t in self.kernels.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps]}


def traced(step, calls: int, spans=()) -> Trace:
    """Runs ``step(i)`` for ``i < calls`` under the profiler, in one span
    ``"slice"`` that ends with a synchronise; ``spans`` names the loop's
    own spans inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("slice"):
            t0 = time.perf_counter()
            for i in range(calls):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.name == "slice" and e.device_type.name == "CPU"]
    start = events[0].time_range.start if events else None
    end = events[0].time_range.end if events else None
    return Trace(prof, start, end, wall, spans=set(spans) | {"slice"})
