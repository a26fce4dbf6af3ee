"""RetinaNet through the port's other entry points, on the CPU: the eval
driver, the bench, the demo, and ``build_detector`` for every RetinaNet
config.

* Eval driver parity: ``eval.py --no-restore`` and the port's driver on
  ``tests/fixture_coco.py`` with the same (JAX-initialised) RetinaNet
  weights, the ``cls_score`` bias raised for two classes so that
  detections exist, and the JAX resize injected into the port (both see
  the same pixels). Per image: equal detection counts and classes, boxes
  within 1e-3 (float32 convolutions in two libraries, as
  ``test_torch_eval.py``), scores within 1e-4; box metrics only (no
  masks); the two ``eval_results.json`` equal. With an oracle predictor
  the box AP is 1.0.
* The bench with ``--model retinanet`` in both dtypes, shrunk.
* The demo CLI (``python -m detectron_tpu_torch.demo``) on the CPU, as
  ``tests/test_demo.py`` runs the root ``demo.py``: two PNG files. Its PNG
  decodes to the pixels it was given, and ``draw_detections`` draws what
  the JAX package's draws, with ``cv2`` and with its numpy fallback.
* ``configs/retinanet_*.yaml`` build in float32 and bf16.
"""

import json
import os
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from detectron_tpu.data import transforms as jT
from detectron_tpu.utils import visualize as jvis
from detectron_tpu_torch import bench, demo
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data import transforms as tT
from detectron_tpu_torch.eval import driver
from detectron_tpu_torch.models.faster_rcnn import Detections
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils import visualize as tvis
from detectron_tpu_torch.utils.weights import from_jax_params
from tests import fixture_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FIXTURE_CFG = ["data.dataset=coco", "data.val_split=val", "data.short_side=96",
               "data.max_size=128", "data.image_size=[128,128]", "model.name=retinanet",
               "model.num_classes=4", "model.fpn_channels=32", "model.frozen_stages=0",
               "train.batch_size=2", "train.max_gt_boxes=8", "parallel.num_devices=1",
               "retinanet.pre_nms_topk=60", "test.detections_per_image=10",
               "data.num_workers=2"]
RAISED = [1, 3]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))


def raised(params, k=3):
    bias = np.array(params["params"]["head"]["cls_score"]["bias"]).reshape(-1, k)
    bias[:, [c - 1 for c in RAISED]] = 0.5
    params["params"]["head"]["cls_score"]["bias"] = bias.reshape(-1)
    return params


def test_driver_matches_eval_py(coco_root, tmp_path, monkeypatch):
    import eval as eval_py

    import detectron_tpu.parallel as parallel

    cfg_list = FIXTURE_CFG + [f"data.root={coco_root}"]
    captured = {}
    make_predict_step = parallel.make_predict_step

    def raised_bias_predict_step(det, mesh, axis="data"):
        predict = make_predict_step(det, mesh, axis)

        def run(params, batch):
            if "params" not in captured:
                captured["params"] = raised(jax.tree_util.tree_map(np.asarray, params))
            return predict(captured["params"], batch)

        return run

    def capture(key):
        def merge(gts, dts):
            captured[key] = (gts, dts)
            return gts, dts
        return merge

    monkeypatch.setattr(parallel, "make_predict_step", raised_bias_predict_step)
    monkeypatch.setattr(eval_py, "merge_across_processes", capture("jax"))
    monkeypatch.setattr(sys, "argv", ["eval.py", "--no-restore", "--cfg", *cfg_list,
                                      f"output_dir={tmp_path / 'jax'}"])
    eval_py.main()

    monkeypatch.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
    monkeypatch.setattr(driver, "merge_across_processes", capture("port"))
    cfg = get_config(None, cfg_list + [f"output_dir={tmp_path / 'port'}"])
    det = build_detector(cfg, device="cpu")
    params = from_jax_params(captured["params"], det.module)
    res = driver.run(cfg, restore=False, device="cpu",
                     predict=lambda _, batch: det.predict_fn(params, batch))
    assert "segm_AP" not in res and np.isfinite(res["AP"])

    j_gts, j_dts = captured["jax"]
    t_gts, t_dts = captured["port"]
    j_at = {int(d["image_id"]): k for k, d in enumerate(j_dts)}
    t_at = {int(d["image_id"]): k for k, d in enumerate(t_dts)}
    assert set(j_at) == set(t_at) == set(range(len(fixture_coco.IMAGE_SIZES)))
    n_dets = 0
    for image_id, jk in j_at.items():
        jd, td = j_dts[jk], t_dts[t_at[image_id]]
        assert "masks" not in td and "masks" not in t_gts[t_at[image_id]]
        assert len(td["scores"]) == len(jd["scores"]), image_id
        np.testing.assert_array_equal(td["classes"], jd["classes"])
        np.testing.assert_allclose(td["boxes"], jd["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(td["scores"], jd["scores"], rtol=0, atol=1e-4)
        n_dets += len(td["scores"])
    assert n_dets > 0
    with open(tmp_path / "jax" / "eval_results.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "eval_results.json") as f:
        got = json.load(f)
    assert got == want


def oracle(params, batch):
    classes = np.asarray(batch["gt_classes"], np.int32)
    valid = classes > 0
    return Detections(boxes=np.asarray(batch["gt_boxes"], np.float32),
                      scores=np.where(valid, 0.9, 0.0).astype(np.float32),
                      classes=classes, valid=valid), None


def test_driver_with_an_oracle_gives_box_ap_one(coco_root, tmp_path):
    cfg = get_config(None, FIXTURE_CFG + [f"data.root={coco_root}",
                                          f"output_dir={tmp_path}"])
    res = driver.run(cfg, restore=False, device="cpu", predict=oracle)
    assert res["AP"] == pytest.approx(1.0, abs=1e-6)
    assert res["AP50"] == pytest.approx(1.0, abs=1e-6)
    assert "segm_AP" not in res
    assert res["timing"]["images"] == len(fixture_coco.IMAGE_SIZES)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_runs_retinanet(dtype, capsys):
    args = bench.parse_args(["--model", "retinanet", "--dtype", dtype, "--size", "128",
                             "--batch", "2", "--train-batch", "2", "--iters", "1",
                             "--train-iters", "1", "--set", "model.fpn_channels=32",
                             "model.num_classes=5", "retinanet.pre_nms_topk=60"])
    out = bench.run(args, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["metric"] == ("retinanet R-50-FPN inference images/sec/chip "
                             f"(128x128, bs=2, {dtype}, cpu)")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        assert np.isfinite(out[key]) and out[key] > 0


DEMO_CFG = ["model.name=retinanet", "model.num_classes=4", "model.fpn_channels=32",
            "data.image_size=[128,128]", "data.short_side=100", "data.max_size=128",
            "retinanet.pre_nms_topk=50", "test.detections_per_image=5"]


def read_png(path):
    """The pixels of a PNG that :func:`demo.write_png` wrote (one IDAT of
    unfiltered RGB rows)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = body
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8],
                                                                       "big")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all() and b"IEND" in chunks
    return rows[:, 1:].reshape(h, w, 3)


def test_demo_cli_writes_two_visualizations(tmp_path):
    out = tmp_path / "vis"
    res = subprocess.run(
        [sys.executable, "-m", "detectron_tpu_torch.demo", "--no-restore", "--device", "cpu",
         "--out", str(out), "--score-threshold", "0.0", "--cfg", *DEMO_CFG,
         f"output_dir={tmp_path / 'run'}"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-2000:]
    files = sorted(out.glob("*.png"))
    assert [f.name for f in files] == ["synthetic_0.png", "synthetic_1.png"]
    for f in files:
        assert read_png(f).shape == (128, 128, 3)
    assert res.stdout.count("detections >= 0.0 -> ") == 2


def test_png_holds_the_pixels(tmp_path):
    rgb = np.random.RandomState(0).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    demo.write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), rgb)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_draw_detections_equals_jax(with_cv2, monkeypatch):
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    boxes = np.array([[5, 6, 60, 70], [-10, 20, 200, 80], [30, 30, 31, 31],
                      [50, 10, 100, 88]], np.float32)
    scores = np.array([0.9, 0.4, 0.7, 0.2], np.float32)
    classes = np.array([1, 3, 2, 1], np.int32)
    valid = np.array([True, True, True, False])
    masks = rng.rand(4, 90, 120) > 0.7
    for kwargs in ({}, {"valid": valid, "masks": masks, "score_threshold": 0.3,
                        "class_names": ["bg", "a", "b", "c"]}):
        want = jvis.draw_detections(image, boxes, scores, classes, **kwargs)
        got = tvis.draw_detections(image, boxes, scores, classes, **kwargs)
        np.testing.assert_array_equal(got, want)
    assert [tvis.class_color(c) for c in range(5)] == [jvis.class_color(c) for c in range(5)]


@pytest.mark.parametrize("name", ["retinanet_r50_fpn_coco.yaml", "retinanet_r50_fpn_voc.yaml",
                                  "retinanet_fast.yaml"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_retinanet_config_builds(name, dtype):
    cfg = get_config(os.path.join(CONFIGS, name), [f"model.dtype={dtype}"])
    det = build_detector(cfg, device="cpu")
    assert det.name == "retinanet" and det.dtype == getattr(torch, dtype)
    k = cfg.model.num_classes - 1
    assert det.module.head.cls_score.out_channels == 9 * k
    assert det.module.head.box_pred.out_channels == 9 * 4
    assert {p.dtype for p in det.module.parameters()} == {torch.float32}
