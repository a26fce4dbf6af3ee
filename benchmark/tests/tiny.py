"""A copy of the benchmark's folder with its cells cut to a size the CPU
runs in seconds: a 128x192 canvas (short side 96, long side at most 160),
two distinct batches of two images, and float32 where a test asks for it.
Widths and depths stay as configured."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CANVAS = {"canvas": [128, 192], "short_side": 96, "max_size": 160}
OVERRIDES = ["data.image_size=[128, 192]", "data.short_side=96", "data.max_size=160"]
MIXES = {"bulk_b16": {"batch": 2, "distinct_batches": 2, "trace_calls": 2},
         "train_b16": {"batch": 2, "distinct_batches": 3, "trace_calls": 2,
                       "settings": {"batch_size": 2, "base_lr": 0.0025}}}


def tiny_copy(tmp: Path, dtype: str = "bfloat16", limits: dict | None = None) -> Path:
    """The benchmark's folder copied under ``tmp`` and cut to size;
    ``limits`` replaces every mix's limits where given."""
    root = Path(tmp) / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["settings"].update(CANVAS, dtype=dtype)
        c["overrides"] = ([o for o in c["overrides"] if not o.startswith("model.dtype=")]
                          + [f"model.dtype={dtype}"] + OVERRIDES)
        path.write_text(json.dumps(c))
    for name, change in MIXES.items():
        path = root / "traffic" / f"{name}.json"
        m = json.loads(path.read_text())
        m.update(change)
        if limits is not None:
            m["limits"] = {k: v for k, v in limits.items() if k in m["limits"]}
        path.write_text(json.dumps(m))
    return root


def spec() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())
