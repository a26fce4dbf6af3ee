"""A new mix and a new per-layer metric are new files and a new entry in
BENCHMARK.json: the harness finds them by name, and no file that is there
changes."""

import hashlib
import json
import shutil

import torch

from benchmark.harness import common
from benchmark.harness.spec import Cell
from benchmark.tests.tiny import BENCH, spec


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_dummy_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(root)
    mix = json.loads((root / "traffic" / "bulk_b16.json").read_text())
    mix["batch"] = 8
    (root / "traffic" / "bulk_b8.json").write_text(json.dumps(mix))
    (root / "metrics" / "calls.bulk.py").write_text(
        '"""calls.bulk: the window\'s predict calls."""\n\n\n'
        "def read(run):\n    return run.stats.get(\"calls\")\n")
    s = spec()
    s["workloads"].append({"name": "mrcnn_r50_bulk_b8", "config": "mask_rcnn_r50_fpn_bf16",
                           "traffic": "bulk_b8", "chips": 1, "why": "a dummy cell"})
    s["end_to_end"][0]["workloads"].append("mrcnn_r50_bulk_b8")
    s["per_layer"].append({"name": "calls.bulk", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "host dispatch",
                           "moves": "infer_img_s", "workloads": ["mrcnn_r50_bulk_b8"]})
    cell = Cell(s, "mrcnn_r50_bulk_b8", root=root)
    assert cell.mix["batch"] == 8
    assert cell.loop().__name__ == "benchmark_loop_bulk"
    assert [m["name"] for m in cell.end_to_end] == ["infer_img_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls.bulk"]
    run = common.Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.stats["calls"] = 12
    assert cell.metric_reader("calls.bulk").read(run) == 12
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
