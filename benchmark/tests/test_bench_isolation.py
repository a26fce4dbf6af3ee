"""What the benchmark may import, and what it does without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = imported_roots(path) & {"jax", "jaxlib", "flax", "detectron_tpu"}
        assert not found, f"{path}: {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        roots = imported_roots(path)
        assert "detectron_tpu_torch" not in roots, path
        assert roots <= {"__future__", "typing", "numpy", "torch", "benchmark"}, (path, roots)
        benchmark_imports = {node.module for node in ast.walk(ast.parse(path.read_text()))
                             if isinstance(node, ast.ImportFrom) and node.module
                             and node.module.startswith("benchmark")}
        assert all(m.startswith("benchmark.reference") for m in benchmark_imports), path


def run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever this runs
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mrcnn_r50_bulk_b16",
                           "--seed", "3000000019", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    out = run(CHECKOUT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
