"""Reads the two ends that a cell's limits are set between, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--seconds 2]

For each seed, in one process: the cell's set-up and a short window as
``run.py`` runs them (``run.measure``), then the comparison numbers of
the program (the lower readings), of the control (the plain reference one
precision below the configuration's bf16, the mix's ``control``, put in
the program's place), and for a training cell of a planted fault (the
reference's step on half of each batch, the mean over that half); a step
that leaves the state unchanged reads 1 on ``update_gap`` by definition
and needs no run. One JSON line a seed. ``run.py`` never runs this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import run as bench_run
    from benchmark.harness import common
    from benchmark.harness.spec import Cell, benchmark_spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(benchmark_spec(CHECKOUT), args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, loop, kept = bench_run.measure(cell, seed, args.seconds, False, device, t0)
        with common.tf32_off():
            readings = loop.calibrate(run, kept)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run, loop, kept
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
