"""The port's stages on the card, from its own spans (``utils/spans.py``).

    python3 scripts/span_profile.py [--workload <cell> ...] [--seed N] [--calls N]
        [--out chiprun_out/span_profile.json]

For each benchmark cell (``BENCHMARK.json``; default both) it builds the
cell's state as ``benchmark/run.py`` does (weights and inputs from the
seed, the shapes warmed), then:

1. runs the benchmark's own traced slice (``loop.traced_slice``) and reads
   the stage metrics from the program's spans of that slice, with the root
   span's device ms beside them: the stage metrics' share of the root;
2. profiles ``--calls`` more of the loop's calls under
   ``torch.profiler`` (CPU and CUDA) and gives, for each stage, its mean
   device and host ms and its three longest kernels, each kernel tied to
   the innermost ``detectron/`` range around the host op that launched it;
   the device's busy time and longest idle gaps come from
   ``benchmark/harness/trace.py``, told the ``detectron/`` ranges, so each
   gap is named by the innermost stage and host op at its middle.

The kernel-to-stage tie is the prototype of what ``trace.py`` should do
itself (a ``benchmark`` change); this script goes when it does. Prints one
JSON object a cell and writes them all to ``--out``. Needs the card; it
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
os.environ.setdefault("CUDA_CACHE_PATH", str(CHECKOUT / "build" / "cuda_cache"))
sys.path.insert(0, str(CHECKOUT))

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="*",
                    default=["mrcnn_r50_bulk_b16", "mrcnn_r101_train_b16"])
    ap.add_argument("--seed", type=int, default=5000001601)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/span_profile.json")
    return ap.parse_args(argv)


def calls_of(loop_name: str, state: dict, loop):
    """``(step(i), finish())``: one of the loop's calls as its traced slice
    makes it, and what ends the last one."""
    from benchmark.harness import common

    if loop_name == "train":
        return (lambda i: loop._step(state)), (lambda: None)
    pending = []

    def step(i):
        fetch = loop._step(state, i)
        if pending:
            common.finish_fetch(pending.pop())
        pending.append(fetch)

    return step, (lambda: pending and common.finish_fetch(pending.pop()))


def stage_metrics(run, cell, root: str) -> dict:
    """The cell's stage metrics from the spans of the traced slice just run,
    and the root span's mean device and host ms in the same slice."""
    from benchmark.harness import stages

    names = [m["name"] for m in cell.per_layer if m["source"] == "program_span"
             and m["name"] != "backward_ms.train"]
    out = {n: cell.metric_reader(n).read(run) for n in names}
    recs = stages.records(run)
    roots = [r for r in recs if r.parent is None and r.name == root]
    out["root_device_ms"] = statistics.fmean(r.device_ms for r in roots)
    out["root_host_ms"] = statistics.fmean(r.host_ms for r in roots)
    children = {r.name for r in recs if r.parent == root}
    for name in sorted(children):
        out[f"{name} device_ms"] = stages.mean_ms(run, root, (name,))
    return out


def innermost(items, at):
    """The name of the shortest ``(start, end, name)`` around ``at``."""
    around = [x for x in items if x[0] <= at <= x[1]]
    return min(around, key=lambda x: x[1] - x[0])[2] if around else None


def attribute(prof, t_lo: float, t_hi: float, wall_s: float) -> dict:
    """Kernels by stage, and ``trace.py``'s busy time and idle gaps with
    the ``detectron/`` ranges among its spans. A kernel belongs to the
    innermost ``detectron/`` host range around the start of the op that
    launched it (by time, not by thread: autograd issues the backward's
    ops from its own thread while the main thread waits inside the
    ``backward`` span)."""
    from benchmark.harness import trace
    from detectron_tpu_torch.utils import spans

    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(spans.PREFIX):])
              for e in events
              if e.device_type.name == "CPU" and e.name.startswith(spans.PREFIX)]
    names = {spans.PREFIX + r[2] for r in ranges} | {"slice", "predict_fn", "fetch",
                                                      "train_step"}
    shadows = {e.name for e in events if e.device_type.name == "CUDA"  # host ranges'
               and (getattr(e, "is_user_annotation", False) or e.name in names)}
    by_stage = defaultdict(lambda: defaultdict(float))  # stage -> kernel -> us
    tied = 0
    for e in events:
        if e.device_type.name != "CPU":
            continue
        for k in e.kernels:
            if k.name not in shadows:
                stage = innermost(ranges, e.time_range.start) or "(outside every span)"
                by_stage[stage][k.name] += k.duration
                tied += 1
    tr = trace.Trace(prof, t_lo, t_hi, wall_s, spans=names)
    top = {stage: sorted(ks.items(), key=lambda kv: -kv[1])[:3]
           for stage, ks in by_stage.items()}
    return {"kernels_tied": tied, "top_kernels_us": top,
            "idle_gaps": tr.breakdown()["idle_gaps"], "slice_s": tr.window_s,
            "busy_s": tr.busy_s}


def profile_calls(step, finish, calls: int) -> tuple:
    """``calls`` calls under the profiler in a ``slice`` range ending in a
    synchronise: the profiler, the range's host start and end (us) and its
    seconds on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("slice"):
            t0 = time.perf_counter()
            for i in range(calls):
                step(i)
            finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    sl = [e for e in prof.events() if e.name == "slice" and e.device_type.name == "CPU"]
    return prof, sl[0].time_range.start, sl[0].time_range.end, wall


def stage_table(records, root: str, calls: int) -> list:
    """Each child span of ``root``: mean device and host ms over the calls."""
    rows = {}
    for r in records:
        if r.parent == root:
            rows.setdefault(r.name, []).append(r)
    return [{"stage": n, "device_ms": sum(r.device_ms for r in rs) / calls,
             "host_ms": sum(r.host_ms for r in rs) / calls} for n, rs in rows.items()]


def profile_cell(name: str, args) -> dict:
    """One cell's numbers (the module doc)."""
    import torch

    from benchmark.harness import common
    from benchmark.harness.spec import Cell, benchmark_spec
    from detectron_tpu_torch.utils import spans

    cell = Cell(benchmark_spec(CHECKOUT), name)
    device = torch.device("cuda", 0)
    run = common.Run(cell, args.seed, 1.0, True, device)
    loop = cell.loop()
    loop_name = cell.mix["loop"]
    root = "predict" if loop_name == "bulk" else "train_step"
    t0 = time.perf_counter()
    state = loop.setup(run)
    common.sync(device)
    out = {"workload": name, "card": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "setup_s": time.perf_counter() - t0,
           "trace_calls": int(cell.mix["trace_calls"])}
    spans.take()
    loop.traced_slice(run, state)
    out["traced_slice"] = stage_metrics(run, cell, root)
    out["traced_slice"]["window_s"] = run.stats["trace"].window_s
    out["traced_slice"]["busy_s"] = run.stats["trace"].busy_s
    out["traced_slice"]["device_ops"] = run.stats["trace"].breakdown()["device_ops"]
    out["traced_slice"]["idle_gaps"] = run.stats["trace"].breakdown()["idle_gaps"]
    run.stats.pop("spans", None)
    step, finish = calls_of(loop_name, state, loop)
    prof, lo, hi, wall = profile_calls(step, finish, args.calls)
    out["stages"] = stage_table(spans.take(), root, args.calls)
    out.update(attribute(prof, lo, hi, wall))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_profile: needs a CUDA device", file=sys.stderr)
        return 2
    results = []
    for name in args.workload:
        res = profile_cell(name, args)
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
