"""The bf16 model (``model.dtype=bfloat16``) of the port against the JAX
package's, on the same (JAX-initialised, float32) weights and inputs.

Config: mask_rcnn, 128x128, num_classes=4, fpn_channels=32,
rpn.pre_nms_topk_test=128, post_nms_topk_test=32, detections_per_image=10,
the cls_score bias raised for two classes (as ``test_torch_detector.py``).

* Parameters: JAX's bf16 model keeps float32 leaves, ``from_jax_params``
  loads them, and the port's bf16 detector holds float32 parameters.
* Backbone + FPN: every level bf16, within 3e-2 x max |level| of JAX's bf16
  levels and of the port's float32 levels (both frameworks round every
  layer's output to bf16 after summing in their own order; measured
  0.9-1.4% and 0.8-1.5%).
* Decode of bf16 deltas against float32 anchors: bit for bit JAX's, at the
  RPN's weights (1, 1, 1, 1) and the box head's (10, 10, 5, 5); float32.
* Proposals from identical bf16 RPN outputs (ties among the scores are
  common in bf16, and forced in one case): boxes, order and validity equal
  to JAX's with ``rpn.exact_topk=true``, scores within one bf16 step (the
  two sigmoids round differently). JAX's default pre-NMS cut,
  ``approx_max_k``, is exact on the CPU as a set but orders bf16 ties
  otherwise than ``lax.top_k`` (float32 ties it orders by index): against
  it the proposals are the same set per image.
* Detections from identical bf16 logits: the port's softmax is the
  float32 softmax rounded once; JAX's bf16 softmax rounds its steps (the
  shifted logits among them), within one bf16 step of it wherever it is
  above ``test.score_thresh`` (55% of all the values equal here; the
  smallest probabilities differ by several steps). A score one step apart
  can reorder the class-aware NMS, so detections are matched as sets: at
  least 80% of JAX's found in the port's (same class, the same box, the
  score within one step; measured 90%).
* The whole predict call: boxes float32, scores and masks bf16, K1 handed
  float32 boxes and K2 bf16 features (through the dispatch points the
  kernel wrappers sit behind); at least 60% of JAX's detections found in
  the port's (same class, IoU >= 0.5: the bf16 convolutions differ, and
  JAX's default RoIAlign casts its interpolation weights to bf16); mask
  probabilities in [0, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models import faster_rcnn as jfrcnn
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.ops import boxes as jboxes
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import faster_rcnn as tfrcnn
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.ops import boxes as tboxes
from detectron_tpu_torch.ops import nms as tnms
from detectron_tpu_torch.ops import roi_align as tra
from detectron_tpu_torch.ops.boxes import bbox_overlaps
from detectron_tpu_torch.utils.weights import from_jax_params

F32 = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
       "data.image_size=[128, 128]", "rpn.pre_nms_topk_test=128",
       "rpn.post_nms_topk_test=32", "test.detections_per_image=10"]
BF16 = F32 + ["model.dtype=bfloat16"]
SEED = 0
BF16_STEP = 2.0 ** -7  # a bf16 value's spacing is at most this share of it
LEVEL_LIMIT = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 exactly)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def as_f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


@pytest.fixture(scope="module")
def run():
    jcfg = jax_get_config(None, BF16)
    jdet = jax_build_detector(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jdet.init(jax.random.PRNGKey(SEED), (128, 128)))
    leaf_dtypes = {leaf.dtype for leaf in jax.tree_util.tree_leaves(variables)}
    bias = np.array(variables["params"]["box_head"]["cls_score"]["bias"])
    bias[[1, 3]] = 3.0
    variables["params"]["box_head"]["cls_score"]["bias"] = bias
    rng = np.random.RandomState(SEED)
    batch = {"image": rng.randn(2, 128, 128, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    j_dets, j_masks = jax.jit(jdet.predict_fn)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    m = jdet.module
    levels = m.apply(variables, jnp.asarray(batch["image"]), method=m.features)
    scores_pl, deltas_pl = m.apply(variables, levels, method=m.rpn)
    anchors_pl = jfrcnn.rpn_anchor_generator(jcfg).grid_anchors((128, 128))
    hw = jnp.asarray(batch["image_hw"])
    exact_cfg = jax_get_config(None, BF16 + ["rpn.exact_topk=true"])
    props = jfrcnn.proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, hw, exact_cfg,
                                      train=False)
    props_approx = jfrcnn.proposals_from_rpn(scores_pl, deltas_pl, anchors_pl, hw, jcfg,
                                             train=False)
    cls_logits, reg = m.apply(variables, levels, props.boxes, method=m.box, fused=False)
    j_inf = jfrcnn.fastrcnn_inference(cls_logits, reg, props.boxes, props.valid, hw, jcfg)

    tcfg = get_config(None, BF16)
    tdet = build_detector(tcfg, device="cpu")
    params = from_jax_params(variables, tdet.module)
    tdet32 = build_detector(get_config(None, F32), device="cpu")
    for det in (tdet, tdet32):
        det.module.load_state_dict(params)
    with torch.no_grad():
        t_levels = tdet.module.features(torch.tensor(batch["image"]))
        t_levels32 = tdet32.module.features(torch.tensor(batch["image"]))
    return dict(tcfg=tcfg, tdet=tdet, params=params, batch=batch, leaf_dtypes=leaf_dtypes,
                j_dets=j_dets, j_masks=j_masks, levels=levels, t_levels=t_levels,
                t_levels32=t_levels32, scores_pl=scores_pl, deltas_pl=deltas_pl,
                anchors_pl=anchors_pl, props=props, props_approx=props_approx,
                cls_logits=cls_logits, reg=reg, j_inf=j_inf)


def test_jax_bf16_params_are_float32_and_load(run):
    assert run["leaf_dtypes"] == {np.dtype("float32")}
    tdet = run["tdet"]
    assert tdet.dtype == torch.bfloat16
    assert {p.dtype for p in tdet.module.parameters()} == {torch.float32}
    assert {v.dtype for v in run["params"].values()} == {torch.float32}
    for name, value in tdet.module.state_dict().items():
        assert torch.equal(value, run["params"][name]), name


def test_backbone_fpn_levels(run):
    for lvl, (got, want, f32) in enumerate(zip(run["t_levels"], run["levels"],
                                               run["t_levels32"])):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        got, want = got.float().numpy(), as_f32(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LEVEL_LIMIT * np.abs(want).max(), lvl
        d32 = np.abs(got - f32.numpy()).max()
        assert 0 < d32 <= LEVEL_LIMIT * np.abs(f32.numpy()).max(), lvl


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_decode_of_bf16_deltas_equals_jax(weights):
    rng = np.random.RandomState(5)
    deltas = torch.tensor(rng.randn(2, 500, 4).astype(np.float32) * 3).to(torch.bfloat16)
    anchors = (rng.rand(500, 4) * 100).astype(np.float32)
    anchors[:, 2:] += anchors[:, :2] + 1
    want = jboxes.decode_boxes(jnp.asarray(deltas.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(anchors), weights)
    got = tboxes.decode_boxes(deltas, torch.tensor(anchors), weights)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def proposals(run, scores_pl, deltas_pl):
    return tfrcnn.proposals_from_rpn(
        [to_torch(s) for s in scores_pl], [to_torch(d) for d in deltas_pl],
        [torch.tensor(np.asarray(a)) for a in run["anchors_pl"]],
        torch.tensor(run["batch"]["image_hw"]), run["tcfg"])


def assert_proposals_equal(got, want):
    assert got.boxes.dtype == torch.float32 and got.scores.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    ref = as_f32(want.scores)
    assert np.all(np.abs(got.scores.float().numpy() - ref) <= BF16_STEP * np.abs(ref))


def test_proposals_equal_jax_on_identical_bf16_rpn_outputs(run):
    scores = np.concatenate([as_f32(s).ravel() for s in run["scores_pl"]])
    assert len(np.unique(scores)) < 0.3 * scores.size  # bf16 ties everywhere
    got = proposals(run, run["scores_pl"], run["deltas_pl"])
    assert int(got.valid.sum()) > 0
    assert_proposals_equal(got, run["props"])
    # JAX's default approx_max_k: the same proposals, bf16 ties in another order
    approx = run["props_approx"]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(approx.valid))
    for i in range(2):
        assert ({tuple(b) for b in got.boxes[i].numpy()}
                == {tuple(b) for b in np.asarray(approx.boxes)[i]})


def test_proposals_with_forced_ties_equal_jax(run):
    """Objectness quantized to a few bf16 values: most slots are decided by
    the tie rule (lower index first, JAX's lax.top_k), the -1e10 padding
    below every real score."""
    jcfg = jax_get_config(None, BF16 + ["rpn.exact_topk=true", "rpn.pre_nms_topk_test=900"])
    tied = [(jnp.round(s.astype(jnp.float32) * 2) / 2).astype(jnp.bfloat16)
            for s in run["scores_pl"]]
    want = jfrcnn.proposals_from_rpn(tied, run["deltas_pl"], run["anchors_pl"],
                                     jnp.asarray(run["batch"]["image_hw"]), jcfg, train=False)
    tcfg = get_config(None, BF16 + ["rpn.pre_nms_topk_test=900"])
    got = tfrcnn.proposals_from_rpn(
        [to_torch(s) for s in tied], [to_torch(d) for d in run["deltas_pl"]],
        [torch.tensor(np.asarray(a)) for a in run["anchors_pl"]],
        torch.tensor(run["batch"]["image_hw"]), tcfg)
    assert len(np.unique(np.concatenate([as_f32(s).ravel() for s in tied]))) <= 8
    assert_proposals_equal(got, want)


def det_match_rate(want, got, score_step: bool) -> float:
    """The share of ``want``'s valid detections found in ``got``: same
    image and class, and the same box and a score within one bf16 step
    (``score_step``), or IoU >= 0.5."""
    found = total = 0
    for i in range(want.valid.shape[0]):
        wv, gv = np.asarray(want.valid[i]), got.valid[i].numpy()
        wb, gb = torch.tensor(np.asarray(want.boxes[i])[wv]), got.boxes[i][gv]
        wc, gc = np.asarray(want.classes[i])[wv], got.classes[i].numpy()[gv]
        ws, gs = as_f32(want.scores[i])[wv], got.scores[i].float().numpy()[gv]
        total += len(wb)
        for j in range(len(wb)):
            if score_step:
                same = ((gb == wb[j]).all(1).numpy()
                        & (np.abs(gs - ws[j]) <= BF16_STEP * abs(ws[j])))
            else:
                same = (bbox_overlaps(wb[j:j + 1], gb)[0] >= 0.5).numpy() if len(gb) else []
            found += bool(np.any(np.asarray(same) & (gc == wc[j])))
    return found / total


def test_fastrcnn_inference_on_identical_bf16_logits(run):
    logits = to_torch(run["cls_logits"])
    probs = torch.softmax(logits, -1)
    assert probs.dtype == torch.bfloat16
    assert torch.equal(probs, torch.softmax(logits.float(), -1).to(torch.bfloat16))
    # above test.score_thresh (the probabilities that can make a detection)
    j_probs = as_f32(jax.nn.softmax(run["cls_logits"], axis=-1))
    above = j_probs > run["tcfg"].test.score_thresh
    assert above.sum() > 0
    diff = np.abs(probs.float().numpy() - j_probs)[above]
    assert np.all(diff <= BF16_STEP * j_probs[above])
    props = run["props"]
    got = tfrcnn.fastrcnn_inference(logits, to_torch(run["reg"]), to_torch(props.boxes),
                                    to_torch(props.valid),
                                    torch.tensor(run["batch"]["image_hw"]), run["tcfg"])
    want = run["j_inf"]
    assert got.boxes.dtype == torch.float32 and got.scores.dtype == torch.bfloat16
    assert want.scores.dtype == jnp.bfloat16
    assert int(np.asarray(want.valid).sum()) > 0
    assert det_match_rate(want, got, score_step=True) >= 0.8


def test_predict_fn_end_to_end(run, monkeypatch):
    seen = {"k1": set(), "k2": set()}
    real_k1, real_k2 = tnms.greedy_keep, tra.multilevel_roi_align_plain

    def k1(sboxes, *args, **kwargs):
        seen["k1"].add(sboxes.dtype)
        return real_k1(sboxes, *args, **kwargs)

    def k2(features, *args, **kwargs):
        seen["k2"].add(features[0].dtype)
        return real_k2(features, *args, **kwargs)

    monkeypatch.setattr(tnms, "greedy_keep", k1)
    monkeypatch.setattr(tra, "multilevel_roi_align_plain", k2)
    dets, masks = run["tdet"].predict_fn(run["params"], run["batch"])
    assert seen == {"k1": {torch.float32}, "k2": {torch.bfloat16}}
    assert dets.boxes.dtype == torch.float32 and dets.scores.dtype == torch.bfloat16
    assert masks.dtype == torch.bfloat16 and masks.shape == (2, 10, 28, 28)
    assert float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0
    assert int(dets.valid.sum()) > 0
    assert det_match_rate(run["j_dets"], dets, score_step=False) >= 0.6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channels_last_computes_what_nchw_computes(run, dtype):
    """The layout the card's measurement flips (``set_channels_last``):
    the same levels in either, within the level limit, NHWC for RoIAlign
    without a copy in channels-last."""
    tcfg = get_config(None, F32 + [f"model.dtype={dtype}"])
    det = build_detector(tcfg, device="cpu")
    det.module.load_state_dict(run["params"])
    images = torch.tensor(run["batch"]["image"])
    with torch.no_grad():
        nchw = det.module.features(images)
        det.module.set_channels_last(True)
        assert det.module.mask_head.memory_format == torch.channels_last
        assert det.module.backbone.conv1.memory_format == torch.channels_last
        last = det.module.features(images)
    for a, b in zip(last, nchw):
        assert a.dtype == b.dtype == getattr(torch, dtype) and a.is_contiguous()
        assert float((a.float() - b.float()).abs().max()) <= LEVEL_LIMIT * float(b.abs().max())
