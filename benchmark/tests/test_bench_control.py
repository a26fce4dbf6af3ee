"""The control: the plain reference one precision below the bf16 that the
configurations state (fp8 for inference, int8 for training: each mix's
``control``), put in the program's place. At a small size
on the CPU its gaps read well above the bf16 program's; on the card, at
the cells' own sizes, ``benchmark/calibrate.py`` reads both ends that the
limits sit between (PERF.md gives the readings)."""

import json
import subprocess
import sys

import torch

from benchmark.harness import common
from benchmark.harness.spec import Cell
from benchmark.tests.tiny import BENCH, spec, tiny_copy


def readings(tmp_path, workload, seed):
    cell = Cell(spec(), workload, root=tiny_copy(tmp_path))
    loop = cell.loop()
    run = common.Run(cell, seed, 0.5, False, torch.device("cpu"))
    state = loop.setup(run)
    loop.window(run, state)
    return loop.calibrate(run, loop.release(run, state))


def test_control_reads_well_above_the_program_on_inference(tmp_path):
    r = readings(tmp_path, "mrcnn_r50_bulk_b16", 3000000029)
    for name in ("rpn_gap", "score_gap", "box_gap", "mask_gap"):
        assert r["control"][name] >= 3 * r["program"][name], (name, r)


def test_control_and_fault_read_above_the_program_on_training(tmp_path):
    r = readings(tmp_path, "mrcnn_r101_train_b16", 3000000031)
    assert r["half_batch"]["loss_gap"] > 3 * r["program"]["loss_gap"]
    for name in ("grad_gap_median", "update_gap_median"):
        assert r["control"][name] >= 3 * r["program"][name], (name, r)


def test_calibrate_at_the_cell_size_on_the_card(card):
    out = subprocess.run([sys.executable, str(BENCH / "calibrate.py"), "--workload",
                          "mrcnn_r50_bulk_b16", "--seeds", "3000000037"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    limits = json.loads((BENCH / "traffic" / "bulk_b16.json").read_text())["limits"]
    assert any(r["control"][k] > v for k, v in limits.items())
    assert all(r["program"][k] <= v for k, v in limits.items())
