"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (a ``workloads`` entry) names a configuration and a traffic mix.
The configuration is ``configs/<name>.json``; the mix is
``traffic/<mix>.json``, whose ``loop`` names the loop module in
``loops/<loop>.py``; each per-layer metric is read by
``metrics/<metric>.py``. All are found by name, so a new cell, mix or
metric is new files and a new entry, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the benchmark's folder
CHECKOUT = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(checkout: Path = CHECKOUT) -> dict:
    return load_json(checkout / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix and
    the metrics it reports."""

    def __init__(self, spec: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.root = root
        self.chips = int(self.entry["chips"])
        self.config = load_json(root / "configs" / f"{self.entry['config']}.json")
        self.mix = load_json(root / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def loop(self):
        """The mix's loop module (``loops/<loop>.py``)."""
        loop = self.mix["loop"]
        return load_module(self.root / "loops" / f"{loop}.py", f"benchmark_loop_{loop}")

    def metric_reader(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py",
                           "benchmark_metric_" + name.replace(".", "_"))
