"""The X-101 bulk cell and the data-parallel training cell, whole runs on the
CPU at a small size with the program in float32 (the harness's look for a
card skipped): sound runs are correct, and a data-parallel step that
leaves one rank's gradient out of the sum is not, by the cell's own
limits. The data-parallel cell runs two ranks here, as processes joined
by gloo."""

import json
import time

import pytest
import torch

import benchmark.run as bench_run
from benchmark.harness.spec import Cell
from benchmark.tests.tiny import spec, tiny_copy

LIMITS = {"rpn_gap": 0.01, "proposal_mismatch": 0, "score_gap": 0.01, "box_gap": 0.01,
          "detection_mismatch": 0, "mask_gap": 0.01, "grad_gap": 0.05, "update_gap": 0.05,
          "grad_gap_median": 0.01, "update_gap_median": 0.01, "replica_mismatch": 0}
MIXES = {"x101_bulk_b16": {"batch": 2, "distinct_batches": 2, "trace_calls": 2},
         "train_dp4_b16": {"ranks": 2, "batch": 1, "distinct_batches": 3, "trace_calls": 2,
                           "period_steps": 1, "reference_block": 1,
                           "settings": {"batch_size": 2, "base_lr": 0.0025}}}


DP_LIMITS = Cell(spec(), "mrcnn_r101_train_dp4").mix["limits"]  # the cell's own


def tiny_cell(tmp_path, workload):
    root = tiny_copy(tmp_path, dtype="float32", limits=LIMITS)
    for name, change in MIXES.items():
        path = root / "traffic" / f"{name}.json"
        m = json.loads(path.read_text())
        m.update(change)
        m["limits"] = (dict(DP_LIMITS) if name == "train_dp4_b16" else
                       {k: v for k, v in LIMITS.items() if k in m["limits"]})
        path.write_text(json.dumps(m))
    return Cell(spec(), workload, root=root)


def run_cell(tmp_path, workload):
    return bench_run.execute(tiny_cell(tmp_path, workload), 3000000023, 1.0, False,
                             torch.device("cpu"), time.perf_counter())


def test_x101_sound_run_is_correct(tmp_path):
    result = run_cell(tmp_path, "mrcnn_x101_bulk_b16")
    assert result["correct"], result["checks"]
    assert result["metrics"]["infer_img_s"]["value"] > 0


def test_dp_sound_run_is_correct_and_its_replicas_agree(tmp_path):
    result = run_cell(tmp_path, "mrcnn_r101_train_dp4")
    assert result["correct"], result["checks"]
    assert result["checks"]["replica_mismatch"]["value"] == 0.0
    assert result["metrics"]["train_img_s"]["value"] > 0


def test_dp_rank_left_out_of_the_sum_is_not_correct(tmp_path, monkeypatch):
    from detectron_tpu_torch.parallel import mesh

    plain = mesh.all_reduce_sum

    def all_reduce_sum(tensors, m):  # rank 0 hands in zeros: its gradient left out
        for t in tensors:
            t.zero_()
        plain(tensors, m)

    monkeypatch.setattr(mesh, "all_reduce_sum", all_reduce_sum)
    result = run_cell(tmp_path, "mrcnn_r101_train_dp4")
    assert not result["correct"], result["checks"]
    assert result["checks"]["replica_mismatch"]["value"] == 0.0  # every rank got the same sum
    assert result["checks"]["grad_gap"]["limit"] == DP_LIMITS["grad_gap"]
    assert result["checks"]["grad_gap"]["value"] > DP_LIMITS["grad_gap"]


def test_dp_calibrate_reads_the_control_and_half_the_ranks_left_out(tmp_path):
    from benchmark.harness import common

    run, loop, kept = bench_run.measure(tiny_cell(tmp_path, "mrcnn_r101_train_dp4"), 3000000041,
                                        1.0, False, torch.device("cpu"), time.perf_counter())
    with common.tf32_off():
        r = loop.calibrate(run, kept)
    assert r["program"]["replica_mismatch"] == 0.0
    assert r["half_batch"]["grad_gap"] > max(3 * r["program"]["grad_gap"], DP_LIMITS["grad_gap"])
    assert r["control"]["grad_gap_median"] >= 3 * r["program"]["grad_gap_median"]


def test_resnext_flop_count_is_the_plain_count_for_one_group():
    from benchmark.harness import flops
    from benchmark.harness import resnext as rx

    bulk = Cell(spec(), "mrcnn_r50_bulk_b16").config["settings"]
    train = Cell(spec(), "mrcnn_r101_train_b16").config["settings"]
    assert rx.image_flops(bulk, False) == flops.image_flops(bulk, False)
    assert rx.image_flops(train, True) == flops.image_flops(train, True)
    x = Cell(spec(), "mrcnn_x101_bulk_b16").config["settings"]
    convs = rx.grouped_convs(x["backbone"], x["canvas"])
    assert len(convs) == 33 and convs[0] == (256, 64, 256, 336, 256, 336)
    assert convs[3][:2] == (512, 64) and convs[3][4:] == (128, 168)  # res3's stride-2 3x3
    layers, _ = rx.backbone_layers(x["backbone"], x["canvas"])
    conv2 = next(l for l in layers if l.name == "layer1.0.conv2")
    assert conv2.flops == 2.0 * 4 * 256 * 9 * 256 * 336  # 2 (cin / g) cout k^2 h w


def test_new_readers_read_the_new_spans_and_stats(monkeypatch):
    from types import SimpleNamespace

    from benchmark.harness import common, resnext as rx
    from detectron_tpu_torch.utils import spans

    def rec(name, parent, call, ms):
        return SimpleNamespace(name=name, parent=parent, call=call, host_ms=ms, device_ms=ms)

    records = []
    for c in range(2):
        records += [rec("predict", None, c, 100.0), rec("backbone+fpn", "predict", c, 60.0)]
        for k, stage in enumerate(("res2", "res3", "res4", "res5")):
            records += [rec(stage, "backbone+fpn", c, 10.0 + k), rec("grouped 3x3", stage, c, 2.0)]
    monkeypatch.setattr(spans, "take", lambda: list(records))
    cell = Cell(spec(), "mrcnn_x101_bulk_b16")
    names = [m["name"] for m in cell.per_layer]
    bulk = {m["name"] for m in Cell(spec(), "mrcnn_r50_bulk_b16").per_layer}
    assert set(names) == bulk | {"trunk_ms.x101bulk", "grouped_conv_ms.x101bulk",
                                 "grouped_conv_roofline.x101bulk"}
    run = common.Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.stats.update(trace=SimpleNamespace(busy_s=0.9, window_s=1.0), calls=10, elapsed_s=1.0,
                     flops_per_call=989e12 / 100, grouped_conv_bound_s=0.004)
    read = {n: cell.metric_reader(n).read(run) for n in names}
    assert read["trunk_ms.x101bulk"] == pytest.approx(46.0)
    assert read["grouped_conv_ms.x101bulk"] == pytest.approx(8.0)
    assert read["grouped_conv_roofline.x101bulk"] == pytest.approx(50.0)
    assert read["mfu.bulk"] == pytest.approx(10.0)
    assert read["idle_pct.bulk"] == pytest.approx(10.0)
    assert rx.grouped_conv_bound_s("resnet50", (1024, 1344), 16) == 0.0
    dp = Cell(spec(), "mrcnn_r101_train_dp4")
    train = {m["name"] for m in Cell(spec(), "mrcnn_r101_train_b16").per_layer}
    assert {m["name"] for m in dp.per_layer} == train | {"allreduce_ms.dp4"}
    assert dp.chips == 4 == dp.mix["ranks"]
    records[:] = [rec("train_step", None, c, 200.0) for c in range(2)] + [
        rec("gradient all-reduce", "train_step", c, 2.0 + c) for c in range(2)]
    run = common.Run(dp, 1, 1.0, True, torch.device("cpu"))
    run.stats.update(trace=object(), calls=10, elapsed_s=1.0, flops_per_call=989e12 / 100)
    assert dp.metric_reader("allreduce_ms.dp4").read(run) == pytest.approx(2.5)
    assert dp.metric_reader("mfu.train").read(run) == pytest.approx(10.0)  # a card's rows
    bare = common.Run(dp, 1, 1.0, True, torch.device("cpu"))  # a run that left nothing
    monkeypatch.setattr(spans, "take", lambda: [])
    assert all(dp.metric_reader(m["name"]).read(bare) is None for m in dp.per_layer)


@pytest.mark.parametrize("block", [1, 2, 4, 6])
def test_loss_norms_counted_in_blocks_are_the_batch_norms(block):
    from benchmark.harness import inputs
    from benchmark.loops import train_dp
    from benchmark.reference import model as ref

    s = {**Cell(spec(), "mrcnn_r101_train_dp4").config["settings"], "canvas": [128, 192],
         "short_side": 96, "max_size": 160, "post_nms_topk_train": 64}
    batch = inputs.coco_like_batches(5, 1, 6, s, "cpu")[0]
    g = torch.Generator().manual_seed(0)
    anchors = sum(a.shape[0] for a in ref.anchors(s, (128, 192), "cpu"))
    draws = ref.TrainDraws(*(torch.rand(6, n, generator=g) for n in (anchors, anchors, 164, 164)))
    corners = torch.rand(6, 64, 4, generator=g).mul(100).sort(-1).values
    props = (corners, torch.rand(6, 64, generator=g) > 0.3)  # x1 <= y1 <= x2 <= y2
    want = ref.loss_norms(s, batch, draws, props)
    got = train_dp.loss_norms_in_blocks(s, batch, draws, props, block)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    with train_dp.norms_in_blocks(block):
        assert ref.loss_norms(s, batch, draws, props)["mask"] == want["mask"]
    assert ref.loss_norms is not None and "lambda" not in repr(ref.loss_norms)
