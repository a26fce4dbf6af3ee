"""The port's bench driver (``python -m detectron_tpu_torch.bench``) on the
CPU at a small size: its ``run(args, device="cpu")`` (the function ``main``
calls) prints one JSON line with ``bench.py``'s keys, the A100 ratios null;
``--dtype bfloat16`` raises, naming ROADMAP.md; without CUDA the default
device raises."""

import json
import math

import pytest
import torch

from detectron_tpu_torch import bench

SMALL = ["--size", "128", "--batch", "2", "--train-batch", "2", "--iters", "1",
         "--train-iters", "1", "--set", "model.fpn_channels=32",
         "model.num_classes=5", "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
         "rpn.pre_nms_topk_train=128", "rpn.post_nms_topk_train=32",
         "roi.batch_per_image=32", "test.detections_per_image=10"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_bench_prints_one_json_line_in_bench_py_format(capsys):
    out = bench.run(bench.parse_args(SMALL), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "train_img_s_chip",
                         "train_step_ms", "train_vs_baseline"}
    assert line["unit"] == "images/sec"
    assert line["vs_baseline"] is None and line["train_vs_baseline"] is None
    assert line["metric"].startswith("mask_rcnn R-50-FPN inference images/sec/chip "
                                     "(128x128, bs=2, float32, cpu)")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        assert math.isfinite(line[key]) and line[key] > 0


def test_bench_train_mode_headlines_train(capsys):
    out = bench.run(bench.parse_args(SMALL + ["--mode", "train"]), device="cpu")
    assert out["value"] == out["train_img_s_chip"]
    assert "train images/sec/chip" in out["metric"]


def test_bench_defaults_and_refusals(monkeypatch):
    args = bench.parse_args([])
    assert (args.size, args.batch, args.train_batch, args.model, args.mode, args.iters,
            args.train_iters, args.dtype) == ("1024", 48, 16, "mask_rcnn", "both", 20, 8,
                                              "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bench.run(bench.parse_args(["--dtype", "bfloat16"]), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(bench.parse_args(SMALL))


def test_bench_sets_frozen_bn_statistics_and_refuses_a_non_finite_loss(monkeypatch, capsys):
    """The timed steps start from statistics of the first batch, not the
    identity; a loss that is not finite fails the run, no line printed."""
    from detectron_tpu_torch.models.resnet import FrozenBatchNorm

    seen = []
    real = bench.calibrate_frozen_bn

    def calibrate(module, images):
        real(module, images)
        seen.extend(m.running_var.clone() for m in module.backbone.modules()
                    if isinstance(m, FrozenBatchNorm))

    def nan_step(state, batch):
        return {"loss_total": torch.tensor(float("nan"))}

    monkeypatch.setattr(bench, "calibrate_frozen_bn", calibrate)
    monkeypatch.setattr(bench, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="training loss"):
        bench.run(bench.parse_args(SMALL + ["--mode", "train"]), device="cpu")
    assert capsys.readouterr().out == ""
    assert seen and not all(torch.equal(v, torch.ones_like(v)) for v in seen)
