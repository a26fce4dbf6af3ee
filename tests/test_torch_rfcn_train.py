"""R-FCN through the port's training step and its other entry points, on
the CPU, against the JAX package where it has a counterpart.

* Training: R-FCN R-50 (C4 trunk), 128x128, num_classes=4,
  fpn_channels=32, train.max_gt_boxes=8, train.grad_clip_norm=1.0, batch 2
  of ``make_batch``; JAX's ``value_and_grad(det.loss_fn)`` +
  ``apply_gradients`` under one ``jit``, the port given the uniform draws
  of JAX's key tree (one RPN level's anchors). Per step the four losses
  agree within 1e-4 relative, and each updated tensor's update within
  ``UPDATE_RTOL`` (chip_smoke.py's phase 10 limit) of JAX's, relative in
  norm. That includes res5, which the C4 trunk never runs: under optax
  weight decay and momentum move it on a zero gradient, and so they do in
  the port. Frozen parameters (stem, layer1) unchanged.
* The loss falls over four steps on one batch in both dtypes (float32
  parameters and gradients in bf16), the stage marks come in order, and
  the train driver runs two synthetic steps.
* Eval driver parity: ``eval.py --no-restore`` and the port's driver on
  ``tests/fixture_coco.py`` with the same (JAX-initialised) R-FCN weights,
  the ``ps_cls`` bias raised for two classes in every group: per image
  equal detection counts and classes, boxes within 1e-3, scores within
  1e-4, box metrics only; the two ``eval_results.json`` equal.
* The bench with ``--model rfcn`` in both dtypes, and the demo CLI, shrunk.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import UPDATE_RTOL
from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data import transforms as jT
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.train import state as jax_state
from detectron_tpu_torch import bench
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data import transforms as tT
from detectron_tpu_torch.eval import driver as eval_driver
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train import driver
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_train import jax_draws
from tests import fixture_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["model.name=rfcn", "model.num_classes=4", "model.fpn_channels=32",
             "data.image_size=[128, 128]", "rpn.pre_nms_topk_train=128",
             "rpn.post_nms_topk_train=32", "roi.batch_per_image=32", "train.batch_size=2",
             "train.max_gt_boxes=8", "train.grad_clip_norm=1.0"]
LOSSES = {"loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box"}
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def train_run():
    jcfg, tcfg = jax_get_config(None, OVERRIDES), get_config(None, OVERRIDES)
    jdet = jax_build_detector(jcfg)
    variables = jdet.init(jax.random.PRNGKey(0), (128, 128))
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    jstate, tx, _ = jax_state.create_train_state(jcfg, variables)
    key0 = jax.random.PRNGKey(1)

    def step(state, jbatch):
        key = jax.random.fold_in(key0, state.step)
        (_, ld), grads = jax.value_and_grad(
            lambda p: jdet.loss_fn(p, jbatch, key), has_aux=True)(state.params)
        return jax_state.apply_gradients(state, grads, tx), ld

    jstep = jax.jit(step)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tdet = build_detector(tcfg, device="cpu")
    params0 = from_jax_params(numpy_tree(variables), tdet.module)
    tst = tstate.create_train_state(tcfg, tdet, {k: v.clone() for k, v in params0.items()})
    num_anchors = tdet.module.anchors((128, 128), "cpu")[0].shape[0]
    j_losses, t_losses = [], []
    for s in range(STEPS):
        jstate, ld = jstep(jstate, jbatch)
        j_losses.append({k: float(v) for k, v in ld.items()})
        draws = jax_draws(key0, s, num_anchors, tcfg.rpn.post_nms_topk_train + 8)
        t_losses.append({k: float(v) for k, v in tstate.train_step(tst, batch, draws).items()})
    return dict(params0=params0, j_losses=j_losses, t_losses=t_losses,
                j_params=from_jax_params(numpy_tree(jstate.params)), t_state=tst,
                num_anchors=num_anchors)


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(train_run, step):
    want, got = train_run["j_losses"][step], train_run["t_losses"][step]
    assert set(want) == LOSSES and set(got) == LOSSES | {"loss_total"}
    assert train_run["num_anchors"] == 8 * 8 * 9  # one level at stride 16
    for name, value in want.items():
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], value, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["loss_total"], sum(want.values()), rtol=1e-4)


def test_updates_match_jax(train_run):
    got, want, before = (train_run["t_state"].params, train_run["j_params"],
                         train_run["params0"])
    assert set(got) == set(want) and train_run["t_state"].step == STEPS
    worst = {}
    for name, value in got.items():
        upd_j = want[name] - before[name]
        if not float(upd_j.abs().max()):
            assert torch.equal(value, before[name]), name
            continue
        worst[name] = float(torch.linalg.vector_norm((value - before[name]) - upd_j)
                            / torch.linalg.vector_norm(upd_j))
    assert any(n.startswith(("trunk.", "ps_cls.", "ps_box.")) for n in worst)
    # res5 is not run on the C4 trunk: weight decay and momentum alone move it
    assert any(n.startswith("backbone.layer4.") for n in worst)
    name = max(worst, key=worst.get)
    assert worst[name] <= UPDATE_RTOL, (name, worst[name])


def test_frozen_params_unchanged(train_run):
    got, before = train_run["t_state"].params, train_run["params0"]
    module = train_run["t_state"].detector.module
    frozen = [n for n, p in module.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.conv1.", "backbone.layer1.")) for n in frozen)
    for name in frozen:
        assert torch.equal(got[name], before[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_falls_and_stays_float32(dtype):
    cfg = get_config(None, OVERRIDES + [f"model.dtype={dtype}", "train.base_lr=0.005",
                                        "train.warmup_steps=0"])
    det = build_detector(cfg, device="cpu")
    state = tstate.create_train_state(cfg, det, det.init(0))
    batch = make_batch(np.random.RandomState(1), 2, (128, 128), 4, max_gt=8)
    marks, totals = [], []
    for _ in range(4):
        totals.append(float(tstate.train_step(state, batch, mark=marks.append)["loss_total"]))
    assert all(np.isfinite(totals)) and totals[-1] < totals[0], totals
    assert marks[:10] == ["anchors+draws", "backbone+trunk", "rpn head", "rpn targets+loss",
                          "proposals (K1)", "roi sampling", "ps maps",
                          "psroipool + vote + loss", "backward", "optimizer"]
    for name, p in det.module.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or p.grad.dtype == torch.float32, name


def test_train_driver_runs_two_synthetic_steps(tmp_path, capsys):
    cfg = get_config(None, OVERRIDES + ["data.dataset=synthetic", "train.max_steps=2",
                                        "train.log_every=1", f"output_dir={tmp_path}"])
    last = driver.run(cfg, device="cpu")
    assert set(last) == LOSSES | {"loss_total"}
    assert all(np.isfinite(v) for v in last.values())
    assert ckpt.latest_step(str(tmp_path)) == 2
    out = capsys.readouterr().out
    assert "model=rfcn" in out and "step 2/2" in out


FIXTURE_CFG = ["data.dataset=coco", "data.val_split=val", "data.short_side=96",
               "data.max_size=128", "data.image_size=[128,128]", "model.name=rfcn",
               "model.num_classes=4", "model.fpn_channels=32", "model.frozen_stages=0",
               "train.batch_size=2", "train.max_gt_boxes=8", "parallel.num_devices=1",
               "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
               "test.detections_per_image=10", "data.num_workers=2"]
RAISED = [1, 3]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))


def raised(params, k=4, p2=49):
    """``params`` with the ``ps_cls`` bias of RAISED raised in every one of
    the ``p2`` groups of ``k`` (background included) channels."""
    bias = np.array(params["params"]["ps_cls"]["bias"]).reshape(p2, k)
    bias[:, RAISED] = 1.0
    params["params"]["ps_cls"]["bias"] = bias.reshape(-1)
    return params


def test_eval_driver_matches_eval_py(coco_root, tmp_path, monkeypatch):
    import eval as eval_py

    import detectron_tpu.parallel as parallel

    cfg_list = FIXTURE_CFG + [f"data.root={coco_root}"]
    captured = {}
    make_predict_step = parallel.make_predict_step

    def raised_bias_predict_step(det, mesh, axis="data"):
        predict = make_predict_step(det, mesh, axis)

        def run(params, batch):
            if "params" not in captured:
                captured["params"] = raised(numpy_tree(params))
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
    monkeypatch.setattr(eval_driver, "merge_across_processes", capture("port"))
    cfg = get_config(None, cfg_list + [f"output_dir={tmp_path / 'port'}"])
    det = build_detector(cfg, device="cpu")
    params = from_jax_params(captured["params"], det.module)
    res = eval_driver.run(cfg, restore=False, device="cpu",
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
        assert "masks" not in td
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_runs_rfcn(dtype, capsys):
    args = bench.parse_args(["--model", "rfcn", "--dtype", dtype, "--size", "128",
                             "--batch", "2", "--train-batch", "2", "--iters", "1",
                             "--train-iters", "1", "--set", "model.fpn_channels=32",
                             "model.num_classes=5", "rpn.pre_nms_topk_test=128",
                             "rpn.post_nms_topk_test=32"])
    out = bench.run(args, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["metric"] == ("rfcn R-50-FPN inference images/sec/chip "
                             f"(128x128, bs=2, {dtype}, cpu)")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        assert np.isfinite(out[key]) and out[key] > 0


def test_bench_refuses_an_unknown_model(capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(["--model", "yolo"])
    assert "invalid choice" in capsys.readouterr().err


def test_demo_cli_draws_rfcn_boxes(tmp_path):
    out = tmp_path / "vis"
    res = subprocess.run(
        [sys.executable, "-m", "detectron_tpu_torch.demo", "--no-restore", "--device", "cpu",
         "--out", str(out), "--score-threshold", "0.0", "--cfg", "model.name=rfcn",
         "model.num_classes=4", "model.fpn_channels=32", "data.image_size=[128,128]",
         "data.short_side=100", "data.max_size=128", "rpn.pre_nms_topk_test=128",
         "rpn.post_nms_topk_test=32", "test.detections_per_image=5",
         f"output_dir={tmp_path / 'run'}"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(f.name for f in out.glob("*.png")) == ["synthetic_0.png", "synthetic_1.png"]
    assert res.stdout.count("5 detections >= 0.0 -> ") == 2
