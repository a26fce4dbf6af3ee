"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, kernel load or build, the detector, weights and
inputs from the seed, the warm-up of the cell's shapes) is ``setup_s``;
then the cell's loop runs for ``--seconds``. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` runs the same window, then a
traced slice and one call whose kernel inputs are captured, and reports
the per-layer metrics with the device's busy time. Either way the
outputs are then held to the plain reference under ``reference/``, and
the numbers compared are printed with their limits, last, on standard
error and in the result line under ``checks``.

No card, fewer cards than the cell asks for, or a JAX module loaded by
the time the result would be printed: exit status 2 or 3, no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# caches inside the checkout, at fixed paths: the kernels' own build
# directory is build/kernels there already
os.environ.setdefault("CUDA_CACHE_PATH", str(CHECKOUT / "build" / "cuda_cache"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "detectron_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up, window, (traced slice), the memory peak, and the release of
    the program's state: ``(run, loop, kept)``, ``kept`` what the check
    reads, on the host. ``run.stats["end_to_end"]`` holds the metrics."""
    import torch

    from benchmark.harness import common

    run = common.Run(cell, seed, seconds, trace, device)
    loop = cell.loop()
    state = loop.setup(run)
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    run.log(f"set-up {setup_s:.3f} s")
    e2e = loop.window(run, state)
    e2e["setup_s"] = setup_s
    if trace:
        loop.traced_slice(run, state)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.stats["memory_peak_bytes"] = peak
    e2e["train_peak_gib"] = peak / 2 ** 30
    run.stats["end_to_end"] = e2e
    kept = loop.release(run, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, loop, kept


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, window, (trace), check: the result line's fields."""
    import torch

    from benchmark.harness import common, compare

    run, loop, kept = measure(cell, seed, seconds, trace, device, t_start)
    t_check = time.perf_counter()
    with common.tf32_off():
        numbers = loop.check(run, kept)
    run.log(f"check {time.perf_counter() - t_check:.3f} s")
    correct, checks = compare.judge(numbers, cell.mix["limits"])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = run.stats["end_to_end"]
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(run.stats["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(run.stats["attempted"]),
              "failed": int(run.stats["failed"]), "metrics": metrics, "device": dev}
    if trace:
        tr = run.stats["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness.spec import Cell, benchmark_spec

    cell = Cell(benchmark_spec(CHECKOUT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
