"""The port's evaluators and eval driver (``detectron_tpu_torch/eval``)
against the JAX package's.

* ``evaluate_coco`` (bbox and segm), ``evaluate_voc`` (both metrics) and
  ``evaluate_mr`` on the same seeded records as the JAX evaluators: every
  metric equal, not close (the same numpy code).
* The eval driver with an oracle ``predict`` that echoes the ground truth
  on ``tests/fixture_coco.py``: box AP = AP50 = 1.0 and segm AP50 = 1.0, as
  ``tests/test_eval_driver.py`` requires of ``eval.py``.
* Driver parity: ``eval.py --no-restore`` and the port's driver on the
  fixture with the same (JAX-initialised) weights, the ``cls_score`` bias
  raised so that detections exist, and the JAX resize injected into the
  port (so both see the same pixels). Per image: equal valid counts and
  classes, boxes within 1e-3 (the two libraries' float32 convolutions,
  as ``test_torch_detector.py``), and mask RLEs equal except at pixels
  whose pasted probability lies within 1e-5 of the threshold on either
  side (a probability that differs in its last bits may cross it there);
  the two ``eval_results.json`` equal.
* ``merge_across_processes`` gathers two gloo processes' records.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from detectron_tpu import native as jnative
from detectron_tpu.data import transforms as jT
from detectron_tpu.eval import coco_eval as jcoco_eval
from detectron_tpu.eval import mr_eval as jmr_eval
from detectron_tpu.eval import voc_eval as jvoc_eval
from detectron_tpu.models import mask_rcnn as jmask
from detectron_tpu_torch import native
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data import transforms as tT
from detectron_tpu_torch.eval import driver, evaluate_coco, evaluate_mr, evaluate_voc
from detectron_tpu_torch.models.faster_rcnn import Detections
from detectron_tpu_torch.models.mask_rcnn import paste_masks_numpy
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils.weights import from_jax_params
from tests import fixture_coco

FIXTURE_CFG = ["data.dataset=coco", "data.val_split=val", "data.short_side=96",
               "data.max_size=128", "data.image_size=[128,128]", "model.name=mask_rcnn",
               "model.num_classes=4", "model.fpn_channels=32", "model.frozen_stages=0",
               "train.batch_size=2", "train.max_gt_boxes=8", "parallel.num_devices=1",
               "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
               "test.detections_per_image=10", "data.num_workers=2"]
RAISED = [1, 3]  # cls_score bias raised: random-init logits sit under score_thresh


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on the machine's cores; PyTorch's
    default of one intra-op thread per core in each of them only makes
    the workers contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))


def rect_mask(box, hw, rng):
    m = np.zeros(hw, bool)
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    m[max(y1, 0):y2, max(x1, 0):x2] = True
    return m ^ (rng.rand(*hw) > 0.995)


def coco_records(seed, n_images=7, num_classes=4, hw=(60, 80)):
    """Seeded gts (crowd regions among them) and detections: jittered copies
    of the gts, duplicates, random boxes, score ties, masks for segm."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    h, w = hw
    for _ in range(n_images):
        g = rng.randint(0, 6)
        xy = rng.uniform([0, 0], [w - 10, h - 10], (g, 2))
        wh = rng.uniform(3, 40, (g, 2))
        gb = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)
        gc = rng.randint(1, num_classes, g)
        ignore = rng.rand(g) < 0.15
        gmasks = [rect_mask(b, hw, rng) for b in gb]
        gts.append({"boxes": gb, "classes": gc, "ignore": ignore,
                    "areas": np.array([m.sum() for m in gmasks], np.float64),
                    "masks": gmasks, "difficult": ignore.astype(np.int32),
                    "ignore_boxes": gb[ignore]})
        k = rng.randint(0, 2 * g + 3)
        src = rng.randint(0, max(g, 1), k)
        db = (gb[src] if g else np.zeros((k, 4), np.float32)) + rng.normal(0, 2.0, (k, 4))
        far = rng.rand(k) < 0.3
        db[far] = rng.uniform(0, 50, (int(far.sum()), 4)).astype(np.float32)
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        db = db.astype(np.float32)
        scores = np.round(rng.rand(k), 1).astype(np.float32)  # ties across images
        dc = np.where(rng.rand(k) < 0.8, gc[src] if g else 1, rng.randint(1, num_classes, k))
        dts.append({"boxes": db, "scores": scores, "classes": dc.astype(np.int32),
                    "masks": [rect_mask(b, hw, rng) for b in db]})
    return gts, dts


def with_rles(records, rle_cls):
    return [dict(r, masks=[rle_cls.encode(m) for m in r["masks"]]) for r in records]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_evaluate_coco_equals_jax(seed, iou_type):
    gts, dts = coco_records(seed)
    got = evaluate_coco(with_rles(gts, native.RLE), with_rles(dts, native.RLE), 4,
                        iou_type=iou_type)
    want = jcoco_eval.evaluate(with_rles(gts, jnative.RLE), with_rles(dts, jnative.RLE), 4,
                               iou_type=iou_type)
    assert set(got) == set(want)
    np.testing.assert_equal(got, want)
    assert np.isfinite(got["AP"])
    # dense masks take the numpy IoU: the same numbers
    if iou_type == "segm":
        np.testing.assert_equal(evaluate_coco(gts, dts, 4, iou_type="segm"), want)


def test_evaluate_coco_max_dets_and_empty():
    gts, dts = coco_records(4)
    got = evaluate_coco(gts, dts, 4, max_dets=(1, 3))
    np.testing.assert_equal(got, jcoco_eval.evaluate(gts, dts, 4, max_dets=(1, 3)))
    assert {"AR1", "AR3"} <= set(got)
    empty = [{"boxes": np.zeros((0, 4), np.float32), "classes": np.zeros(0, int),
              "scores": np.zeros(0, np.float32)}]
    np.testing.assert_equal(evaluate_coco(empty, empty, 3), jcoco_eval.evaluate(empty, empty, 3))


@pytest.mark.parametrize("use_07", [False, True])
def test_evaluate_voc_equals_jax(use_07):
    for seed in (0, 5):
        gts, dts = coco_records(seed)
        got = evaluate_voc(gts, dts, 4, use_07_metric=use_07)
        np.testing.assert_equal(got, jvoc_eval.evaluate_voc(gts, dts, 4, use_07_metric=use_07))
        assert 0.0 < got["mAP"] <= 1.0


def test_evaluate_mr_equals_jax():
    for seed in (0, 6):
        gts, dts = coco_records(seed)
        got = evaluate_mr(gts, dts)
        np.testing.assert_equal(got, jmr_eval.evaluate_mr(gts, dts))
        assert 0.0 < got["MR-2"] < 1.0


def oracle(params, batch):
    """Detections that are the ground truth, in resized coordinates, as the
    real model would give them; masks are the gt box-frame rasters (None
    for a dataset without masks)."""
    classes = np.asarray(batch["gt_classes"], np.int32)
    valid = classes > 0
    dets = Detections(boxes=np.asarray(batch["gt_boxes"], np.float32),
                      scores=np.where(valid, 0.9, 0.0).astype(np.float32),
                      classes=classes, valid=valid)
    masks = batch.get("gt_masks")
    return dets, None if masks is None else np.asarray(masks, np.float32)


def make_citypersons_fixture(root):
    """Three 128x256 images in the Cityscapes layout: 1-3 pedestrians each,
    an ignore region and a rider (an ignore region under the Reasonable
    protocol)."""
    import cv2

    ann_dir = root / "gtBboxCityPersons" / "val" / "testcity"
    img_dir = root / "leftImg8bit" / "val" / "testcity"
    ann_dir.mkdir(parents=True)
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(7)
    for i in range(3):
        h, w = 128, 256
        objs = []
        for _ in range(1 + i):
            bw, bh = int(rng.randint(20, 40)), int(rng.randint(60, 100))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            objs.append({"label": "pedestrian", "bbox": [x, y, bw, bh],
                         "bboxVis": [x, y, bw, bh]})
        objs.append({"label": "ignore", "bbox": [int(w * 0.8), 5, 30, 30]})
        objs.append({"label": "rider", "bbox": [150, 10, 40, 100],
                     "bboxVis": [150, 10, 40, 100]})
        with open(ann_dir / f"c_{i:06d}_gtBboxCityPersons.json", "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)
        cv2.imwrite(str(img_dir / f"c_{i:06d}_leftImg8bit.png"),
                    np.full((h, w, 3), 60, np.uint8))
    return str(root)


def test_citypersons_dataset_matches_jax(tmp_path):
    from detectron_tpu.data.citypersons import CityPersonsDataset as JaxCityPersons
    from detectron_tpu_torch.data.citypersons import CityPersonsDataset

    root = make_citypersons_fixture(tmp_path)
    got, want = CityPersonsDataset(root, "val"), JaxCityPersons(root, "val")
    assert len(got) == len(want) == 3 and got.num_classes == 2
    for i in range(3):
        g, w = got.example(i), want.example(i)
        assert set(g) == set(w)
        for k, v in w.items():
            np.testing.assert_array_equal(g[k], v, err_msg=k)
        assert got.index_of(w["image_id"]) == i
    assert len(got.example(0)["ignore_boxes"]) == 2  # the ignore region and the rider


@pytest.mark.parametrize("dataset", ["voc", "citypersons"])
def test_driver_dataset_branches_with_an_oracle(dataset, tmp_path):
    """The driver's other two protocols: VOC mAP 1.0 and MR^-2 0.0 for the
    ground truth echoed back (the crowd-free branches of ``eval.py``)."""
    from tests import fixture_voc

    if dataset == "voc":
        root = fixture_voc.make_fixture(str(tmp_path / "voc"))
        extra = ["data.dataset=voc", "data.val_split=test", "model.num_classes=21"]
    else:
        root = make_citypersons_fixture(tmp_path / "cp")
        extra = ["data.dataset=citypersons", "data.val_split=val", "model.num_classes=2",
                 "data.image_size=[96,192]", "data.max_size=192", "train.batch_size=1"]
    cfg = get_config(None, FIXTURE_CFG + ["model.name=faster_rcnn", f"data.root={root}",
                                          f"output_dir={tmp_path / 'out'}"] + extra)
    res = driver.run(cfg, restore=False, device="cpu", predict=oracle)
    if dataset == "voc":
        assert res["mAP"] == pytest.approx(1.0, abs=1e-6)
    else:
        assert res["MR-2"] == pytest.approx(0.0, abs=1e-9)


def test_driver_with_an_oracle_gives_exact_map(coco_root, tmp_path):
    cfg = get_config(None, FIXTURE_CFG + [f"data.root={coco_root}",
                                          f"output_dir={tmp_path}"])
    res = driver.run(cfg, restore=False, device="cpu", predict=oracle)
    assert res["AP"] == pytest.approx(1.0, abs=1e-6)
    assert res["AP50"] == pytest.approx(1.0, abs=1e-6)
    # 28x28 box-frame rasters pasted back match the polygons at AP50 exactly
    assert res["segm_AP50"] == pytest.approx(1.0, abs=1e-6)
    assert res["segm_AP"] > 0.5
    timing = res.pop("timing")
    assert timing["images"] == len(fixture_coco.IMAGE_SIZES) and timing["batches"] == 3
    assert timing["device_ms_per_call"] == []  # events only on the card
    with open(tmp_path / "eval_results.json") as f:
        written = json.load(f)
    assert written == {k: (None if isinstance(v, float) and v != v else v)
                       for k, v in res.items() if k != "per_class"}
    # --limit: the first N images only, and no batch dispatched past them
    res = driver.run(cfg, limit=3, restore=False, device="cpu", predict=oracle)
    assert res["timing"]["images"] == 3 and res["timing"]["batches"] == 2


def test_driver_defaults_to_the_card_and_restores_params(coco_root, tmp_path, monkeypatch):
    cfg = get_config(None, FIXTURE_CFG + [f"data.root={coco_root}",
                                          f"output_dir={tmp_path}"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(cfg, restore=False, predict=oracle)
    # model.weights is read: a torchvision-named backbone dict is loaded
    rng = np.random.RandomState(3)
    src = {k.removeprefix("backbone.").replace("downsample_conv", "downsample.0")
           .replace("downsample_bn", "downsample.1"): torch.tensor(
               rng.randn(*v.shape).astype(np.float32))
           for k, v in build_detector(cfg, device="cpu").init(0).items()
           if k.startswith("backbone.")}
    torch.save(src, str(tmp_path / "r50.pth"))
    loaded = {}

    def grab(params, batch):
        loaded.setdefault("conv", params["backbone.layer4.2.conv3.weight"])
        loaded.setdefault("ds", params["backbone.layer2.0.downsample_bn.running_var"])
        return oracle(params, batch)

    driver.run(get_config(None, FIXTURE_CFG + [f"data.root={coco_root}",
                                               f"model.weights={tmp_path / 'r50.pth'}",
                                               f"output_dir={tmp_path / 'weights'}"]),
               restore=False, device="cpu", predict=grab)
    assert torch.equal(loaded["conv"], src["layer4.2.conv3.weight"])
    assert torch.equal(loaded["ds"], src["layer2.0.downsample.1.running_var"])
    # a checkpoint in output_dir is restored (params only), and used
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train.state import create_train_state

    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, det.init(5))
    state.step = 7
    ckpt.save(str(tmp_path), state)
    seen = {}

    def spy(params, batch):
        seen["bias"] = params["box_head.cls_score.bias"]
        return oracle(params, batch)

    driver.run(cfg, limit=2, device="cpu", predict=spy)
    torch.testing.assert_close(seen["bias"], state.params["box_head.cls_score.bias"])
    params, step = ckpt.restore_params(str(tmp_path), det.init(0))
    assert step == 7 and torch.equal(params["backbone.conv1.weight"],
                                      state.params["backbone.conv1.weight"])


def record_pastes(monkeypatch, module, name):
    """Wraps ``module.name`` (a paste_masks_rle) to record its inputs: one
    call per detection record, in the order the records are built."""
    calls = []
    real = getattr(module, name)

    def paste(masks, boxes, valid, hw, threshold=0.5):
        calls.append((np.array(masks), np.array(boxes), np.array(valid), hw, threshold))
        return real(masks, boxes, valid, hw, threshold=threshold)

    monkeypatch.setattr(module, name, paste)
    return calls


def near_threshold(call, band=1e-5):
    """Pixels whose pasted probability lies within ``band`` of the threshold."""
    masks, boxes, valid, hw, th = call
    lo = paste_masks_numpy(masks, boxes.astype(np.float32), valid, hw, th - band)
    hi = paste_masks_numpy(masks, boxes.astype(np.float32), valid, hw, th + band)
    return lo.astype(bool) & ~hi.astype(bool)


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
                params = jax.tree_util.tree_map(np.asarray, params)
                bias = np.array(params["params"]["box_head"]["cls_score"]["bias"])
                bias[RAISED] = 3.0
                params["params"]["box_head"]["cls_score"]["bias"] = bias
                captured["params"] = params
            return predict(captured["params"], batch)

        return run

    def capture(key):
        def merge(gts, dts):
            captured[key] = (gts, dts)
            return gts, dts
        return merge

    # eval.py, as a user runs it
    monkeypatch.setattr(parallel, "make_predict_step", raised_bias_predict_step)
    monkeypatch.setattr(eval_py, "merge_across_processes", capture("jax"))
    j_pastes = record_pastes(monkeypatch, jmask, "paste_masks_rle")
    monkeypatch.setattr(sys, "argv", ["eval.py", "--no-restore", "--cfg", *cfg_list,
                                      f"output_dir={tmp_path / 'jax'}"])
    eval_py.main()

    # the port's driver on the same weights, seeing the same pixels
    monkeypatch.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
    monkeypatch.setattr(driver, "merge_across_processes", capture("port"))
    t_pastes = record_pastes(monkeypatch, driver, "paste_masks_rle")
    cfg = get_config(None, cfg_list + [f"output_dir={tmp_path / 'port'}"])
    det = build_detector(cfg, device="cpu")
    params = from_jax_params(captured["params"], det.module)
    driver.run(cfg, restore=False, device="cpu",
               predict=lambda _, batch: det.predict_fn(params, batch))

    j_gts, j_dts = captured["jax"]
    t_gts, t_dts = captured["port"]
    j_at = {int(d["image_id"]): k for k, d in enumerate(j_dts)}
    t_at = {int(d["image_id"]): k for k, d in enumerate(t_dts)}
    assert set(j_at) == set(t_at) == set(range(len(fixture_coco.IMAGE_SIZES)))
    n_dets = n_differing = 0
    for image_id, jk in j_at.items():
        tk = t_at[image_id]
        jd, td = j_dts[jk], t_dts[tk]
        assert len(td["scores"]) == len(jd["scores"]), image_id
        np.testing.assert_array_equal(td["classes"], jd["classes"])
        np.testing.assert_allclose(td["boxes"], jd["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(td["scores"], jd["scores"], rtol=0, atol=1e-4)
        band = near_threshold(t_pastes[tk]) | near_threshold(j_pastes[jk])
        for i, (tm, jm) in enumerate(zip(td["masks"], jd["masks"])):
            differ = tm.decode() != jm.decode()
            assert not (differ & ~band[i]).any(), (image_id, i)
            n_differing += int(differ.sum())
        n_dets += len(td["scores"])
        for key in ("boxes", "classes", "ignore", "areas"):
            np.testing.assert_array_equal(t_gts[tk][key], j_gts[jk][key])
        for tm, jm in zip(t_gts[tk]["masks"], j_gts[jk]["masks"]):
            np.testing.assert_array_equal(tm.counts, jm.counts)
    assert n_dets > 0
    with open(tmp_path / "jax" / "eval_results.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "eval_results.json") as f:
        got = json.load(f)
    assert got == want


MERGE_WORKER = """
import json, sys
import torch
from detectron_tpu_torch.eval import driver
rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                     world_size=2, rank=rank)
try:
    assert driver.process_index_count() == (rank, 2)
    print(json.dumps(driver.merge_across_processes([{"id": rank}], [{"det": rank * 10}])))
finally:
    torch.distributed.destroy_process_group()
"""


def test_merge_across_processes_gathers_in_rank_order():
    import socket
    import subprocess

    assert driver.merge_across_processes([1], [2]) == ([1], [2])  # no group: a no-op
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", MERGE_WORKER, str(rank), str(port)],
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1]) == [[{"id": 0}, {"id": 1}],
                                                            [{"det": 0}, {"det": 10}]]
