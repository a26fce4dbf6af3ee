"""The bf16 inference slice through to COCO metrics on the repo's fixture
(``tests/fixture_coco.py``): ``eval.py`` with ``model.dtype=bfloat16`` and
the port's eval driver in bf16 and in float32, on the same
(JAX-initialised) weights with the ``cls_score`` bias raised as
``test_torch_eval.py`` raises it, the JAX resize injected into the port.

* The float32 run has detections and a box AP above 0 (so the comparison
  means something; at random weights it is small: measured box AP 9.1e-4,
  AP50 9.1e-3, segm AP 0).
* Box AP, AP50 and segm AP of the port in bf16 within 0.005 absolute of
  ``eval.py`` in bf16 and of the port's own float32 run (0.02 would be the
  looser bound; measured differences at most 5.5e-4).
* The driver's fetch takes bf16 outputs: scores and mask probabilities
  reach the host as float32 holding the bf16 values themselves.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from detectron_tpu.data import transforms as jT
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data import transforms as tT
from detectron_tpu_torch.eval import driver
from detectron_tpu_torch.models.faster_rcnn import Detections
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils.weights import from_jax_params
from tests import fixture_coco
from tests.test_torch_eval import FIXTURE_CFG, RAISED

AP_TOL = 0.005
KEYS = ("AP", "AP50", "segm_AP")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def metrics(tmp_path_factory):
    import eval as eval_py

    import detectron_tpu.parallel as parallel

    root = fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))
    out = tmp_path_factory.mktemp("out")
    cfg_list = FIXTURE_CFG + [f"data.root={root}"]
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

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel, "make_predict_step", raised_bias_predict_step)
        mp.setattr(sys, "argv", ["eval.py", "--no-restore", "--cfg", *cfg_list,
                                 "model.dtype=bfloat16", f"output_dir={out / 'jax'}"])
        eval_py.main()
        mp.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
        found = {"jax_bf16": _read(out / "jax")}
        for dtype in ("bfloat16", "float32"):
            cfg = get_config(None, cfg_list + [f"model.dtype={dtype}",
                                               f"output_dir={out / dtype}"])
            det = build_detector(cfg, device="cpu")
            params = from_jax_params(captured["params"], det.module)
            res = driver.run(cfg, restore=False, device="cpu",
                             predict=lambda _, batch, det=det, params=params:
                             det.predict_fn(params, batch))
            found[dtype] = dict({k: res[k] for k in KEYS},
                                detections=res["timing"]["detections"])
    return found


def _read(path):
    import json

    with open(path / "eval_results.json") as f:
        return json.load(f)


def test_float32_run_has_detections_and_box_ap(metrics):
    assert metrics["float32"]["detections"] > 0 and metrics["bfloat16"]["detections"] > 0
    assert metrics["float32"]["AP"] > 0.0


@pytest.mark.parametrize("key", KEYS)
def test_bf16_ap_within_tolerance_of_jax_bf16_and_port_float32(metrics, key):
    got = metrics["bfloat16"][key]
    assert abs(got - metrics["jax_bf16"][key]) <= AP_TOL, (key, metrics)
    assert abs(got - metrics["float32"][key]) <= AP_TOL, (key, metrics)


def test_fetch_takes_bf16_outputs():
    """On the CPU ``start_fetch`` hands the outputs on as they are and
    ``to_numpy`` upcasts bf16 exactly; the driver's consume reads them so."""
    scores = torch.tensor([[0.9, 0.3336]]).to(torch.bfloat16)
    masks = torch.rand(1, 2, 28, 28).to(torch.bfloat16)
    dets = Detections(boxes=torch.zeros(1, 2, 4), scores=scores,
                      classes=torch.ones(1, 2, dtype=torch.int32),
                      valid=torch.ones(1, 2, dtype=torch.bool))
    fields, event = driver.start_fetch(dets, masks)
    assert event is None
    got = [driver.to_numpy(x) for x in fields]
    assert got[1].dtype == np.float32 and got[4].dtype == np.float32
    np.testing.assert_array_equal(got[1], scores.float().numpy())
    np.testing.assert_array_equal(got[4], masks.float().numpy())
    assert driver.upcast(scores).dtype == torch.float32
    assert driver.upcast(dets.boxes) is dets.boxes
