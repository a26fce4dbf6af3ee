"""The slice as a whole: the port's Mask R-CNN inference against the JAX
package's, on the same (JAX-initialised) weights and inputs.

Config: mask_rcnn, 128x128, num_classes=4, fpn_channels=32,
rpn.pre_nms_topk_test=128, post_nms_topk_test=32, detections_per_image=10,
with the cls_score bias raised for two classes so that detections exist
(random-init logits sit near 1/K, under test.score_thresh).

* Stage tests feed both sides identical inputs (JAX's RPN outputs to
  generate_proposals, JAX's box-head outputs to fastrcnn_inference):
  ``valid`` and ``classes`` equal slot for slot, boxes and scores within
  1e-5 (float32 decode/softmax in two libraries).
* End to end through predict_fn: ``valid`` and ``classes`` equal, boxes
  within 1e-3 (image coordinates, about 1e-4 relative after the conv
  stack's reassociation) and mask probabilities within 1e-4. Seed 0 gives
  no near-tie between scores; a seed that did would need changing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models import faster_rcnn as jfrcnn
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import faster_rcnn as tfrcnn
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils.weights import from_jax_params

OVERRIDES = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
             "data.image_size=[128, 128]", "rpn.pre_nms_topk_test=128",
             "rpn.post_nms_topk_test=32", "test.detections_per_image=10"]
SEED = 0


@pytest.fixture(scope="module")
def slice_run():
    jcfg, tcfg = jax_get_config(None, OVERRIDES), get_config(None, OVERRIDES)
    jdet = jax_build_detector(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jdet.init(jax.random.PRNGKey(SEED), (128, 128)))
    bias = np.array(variables["params"]["box_head"]["cls_score"]["bias"])
    bias[[1, 3]] = 3.0
    variables["params"]["box_head"]["cls_score"]["bias"] = bias
    rng = np.random.RandomState(SEED)
    batch = {"image": rng.randn(2, 128, 128, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    jpredict = jax.jit(jdet.predict_fn)
    j_dets, j_masks = jpredict(variables, {k: jnp.asarray(v) for k, v in batch.items()})

    # JAX's intermediate outputs, for the stage tests
    m = jdet.module
    levels = m.apply(variables, jnp.asarray(batch["image"]), method=m.features)
    scores_pl, deltas_pl = m.apply(variables, levels, method=m.rpn)
    anchors_pl = jfrcnn.rpn_anchor_generator(jcfg).grid_anchors((128, 128))
    props = jfrcnn.proposals_from_rpn(scores_pl, deltas_pl, anchors_pl,
                                      jnp.asarray(batch["image_hw"]), jcfg, train=False)
    cls_logits, reg = m.apply(variables, levels, props.boxes, method=m.box,
                              fused=False)
    j_inf = jfrcnn.fastrcnn_inference(cls_logits, reg, props.boxes, props.valid,
                                      jnp.asarray(batch["image_hw"]), jcfg)

    tdet = build_detector(tcfg, device="cpu")
    params = from_jax_params(variables, tdet.module)
    t_dets, t_masks = tdet.predict_fn(params, batch)
    return dict(tcfg=tcfg, batch=batch, j_dets=j_dets, j_masks=j_masks,
                t_dets=t_dets, t_masks=t_masks, scores_pl=scores_pl,
                deltas_pl=deltas_pl, anchors_pl=anchors_pl, props=props,
                cls_logits=cls_logits, reg=reg, j_inf=j_inf)


def t(x):
    return torch.tensor(np.asarray(x))


def test_generate_proposals_on_jax_rpn_outputs(slice_run):
    r = slice_run
    got = tfrcnn.proposals_from_rpn(
        [t(s) for s in r["scores_pl"]], [t(d) for d in r["deltas_pl"]],
        [t(a) for a in r["anchors_pl"]], t(r["batch"]["image_hw"]), r["tcfg"])
    want = r["props"]
    assert got.boxes.shape == (2, 32, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def test_fastrcnn_inference_on_jax_box_outputs(slice_run):
    r = slice_run
    props = r["props"]
    got = tfrcnn.fastrcnn_inference(t(r["cls_logits"]), t(r["reg"]), t(props.boxes),
                                    t(props.valid), t(r["batch"]["image_hw"]), r["tcfg"])
    want = r["j_inf"]
    assert int(np.asarray(want.valid).sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def test_predict_fn_end_to_end(slice_run):
    r = slice_run
    jd, td = r["j_dets"], r["t_dets"]
    assert td.boxes.shape == (2, 10, 4) and td.valid.dtype == torch.bool
    assert int(td.valid.sum()) > 0
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.classes.numpy(), np.asarray(jd.classes))
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), rtol=0, atol=1e-4)


def test_mask_probabilities_end_to_end(slice_run):
    r = slice_run
    masks = r["t_masks"]
    assert masks.shape == (2, 10, 28, 28)
    assert float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0
    np.testing.assert_allclose(masks.numpy(), np.asarray(r["j_masks"]), rtol=0, atol=1e-4)


def test_predict_fn_with_module_weights_equals_params(slice_run):
    """predict_fn(None, batch) runs the module's own weights."""
    r = slice_run
    tdet = build_detector(r["tcfg"], device="cpu")
    params = tdet.init(seed=3)
    tdet.module.load_state_dict(params)
    a, _ = tdet.predict_fn(None, r["batch"])
    b, _ = tdet.predict_fn(params, r["batch"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
