"""The port's RoIPool (``ops/roi_align.py::multilevel_roi_pool``,
``roi_pool``; ``roi.pool_type=pool``) against the JAX package's.

* Forward, **bit for bit** in float32 and in bf16 (a max of the same values
  is exact; JAX takes the max in float32 of the upcast features and casts
  back, the port in the features' dtype), over P2-P5 levels of a 256x320
  canvas at P=7 and 14, and over one level (``roi_pool``): random RoIs,
  RoIs whose every coordinate falls on a half cell of their level (``round``
  takes half to even in both), past the border, degenerate (inverted and
  empty), at the routing span's limit (28 rows, 36 columns), the whole
  canvas (P4 whole), past the canvas (P5, the coarsest level, whole: the
  window grows to hold it), and far larger than the canvas (bins clipped
  to the window).
* The gradient (autograd through the sparse tables' maxima and the
  gather) against ``jax.grad`` within 1e-6 of its magnitude (sums of the
  same terms in another order).
* The trap: jitted, the JAX function rewrites ``extent / pool`` as a
  multiplication by the rounded reciprocal, and its bins grow by a cell
  wherever a bin's end is an exact integer; the port divides, as the
  reference CUDA kernel and the JAX function op by op do.
* Faster R-CNN R-50-FPN with ``roi.pool_type=pool`` against the jitted
  JAX model with that division kept (``bins_dividing_truly``), no RoIAlign
  call: ``predict_fn`` (Mask R-CNN, whose mask head pools too): valid
  slots and classes equal, boxes within 1e-3, mask probabilities within
  1e-4; one Faster R-CNN train step on JAX's draws: losses within 1e-4
  relative, updates within ``UPDATE_RTOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import UPDATE_RTOL
from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.ops import roi_align as jra
from detectron_tpu.train import state as jax_state
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.ops import roi_align as tra
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_train import jax_draws

STRIDES = (4, 8, 16, 32)
CANVAS = (256, 320)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def levels(c=8, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, CANVAS[0] // s, CANVAS[1] // s, c).astype(dtype) for s in STRIDES]


def pool_rois(seed=1, r=60):
    """Random RoIs and every edge case of the module docstring."""
    rng = np.random.RandomState(seed)
    h, w = CANVAS
    xy = rng.uniform([-30, -30], [w, h], size=(2, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(400), size=(2, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    cases = [
        [2.0, 6.0, 42.0, 46.0],  # P2: 0.5, 1.5, 10.5, 11.5 cells -> 0, 2, 10, 12
        [10.0, 18.0, 38.0, 30.0],  # P2: 2.5, 4.5, 9.5, 7.5
        [12.0, 20.0, 236.0, 36.0],  # P3 by span: (12, 20, 236, 36) / 8 = .5 cells
        [-100.0, -80.0, 60.0, 50.0],  # past the top-left border
        [w - 30.0, h - 20.0, w + 200.0, h + 150.0],  # past the bottom-right
        [50.0, 60.0, 40.0, 55.0],  # inverted
        [70.0, 70.0, 70.0, 70.0],  # empty
        [8.0, 8.0, 24.0, 8.0 + 28 * 8],  # 28 rows at P3: the span's limit
        [8.0, 8.0, 8.0 + 36 * 8, 24.0],  # 36 columns at P3
        [0.0, 0.0, float(w), float(h)],  # the whole canvas: P4 whole
        [-120.0, -110.0, w + 120.0, h + 114.0],  # past the canvas: P5 whole
        [-600.0, -500.0, w + 700.0, h + 650.0],  # far past the canvas
    ]
    rois[:, :len(cases)] = np.array(cases)
    return rois.astype(np.float32)


def jax_pool(feats, rois, p):
    return np.asarray(jra.multilevel_roi_pool([jnp.asarray(f) for f in feats],
                                              jnp.asarray(rois), STRIDES, p))


@pytest.mark.parametrize("p", [7, 14])
def test_multilevel_roi_pool_equals_jax(p):
    feats, rois = levels(), pool_rois()
    want = jax_pool(feats, rois, p)
    got = tra.multilevel_roi_pool([torch.tensor(f) for f in feats], torch.tensor(rois),
                                  STRIDES, p)
    assert got.shape == (2, 60, p, p, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cases reach every level, empty bins (0) and the coarsest level whole
    lv = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=tra.roi_pool_max_span())
    assert set(lv.flatten().tolist()) == {0, 1, 2, 3}
    assert lv[0, 9] == 2 and lv[0, 10] == lv[0, 11] == 3
    assert lv[0, 7] == lv[0, 8] == 1
    # empty bins: those of the RoI past the top-left border that lie outside
    assert (want[:, 3] == 0).all(-1).any() and not (want[:, 3] == 0).all()


def test_roi_pool_single_level_equals_jax():
    feat, rois = levels(seed=2)[1], pool_rois(seed=3)
    want = np.asarray(jra.roi_pool(jnp.asarray(feat), jnp.asarray(rois), 8, 7))
    got = tra.roi_pool(torch.tensor(feat), torch.tensor(rois), 8, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_features_equal_jax():
    feats = [torch.tensor(f).to(torch.bfloat16) for f in levels(seed=4)]
    rois = pool_rois(seed=5)
    want = jra.multilevel_roi_pool(
        [jnp.asarray(f.float().numpy()).astype(jnp.bfloat16) for f in feats],
        jnp.asarray(rois), STRIDES, 7)
    got = tra.multilevel_roi_pool(feats, torch.tensor(rois), STRIDES, 7)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_gradient_matches_jax():
    feats, rois = levels(seed=6), pool_rois(seed=7)
    g = np.random.RandomState(8).randn(2, 60, 7, 7, 8).astype(np.float32)
    want = jax.grad(lambda fs: jnp.sum(jra.multilevel_roi_pool(
        fs, jnp.asarray(rois), STRIDES, 7) * g))([jnp.asarray(f) for f in feats])
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    (tra.multilevel_roi_pool(tf, torch.tensor(rois), STRIDES, 7) * torch.tensor(g)).sum().backward()
    for w, t in zip(want, tf):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-6 * np.abs(w).max()


def test_routing_span_is_the_window_of_32():
    cfg = get_config(None, ["roi.pool_type=pool", "roi.window=16", "roi.align_impl=window"])
    assert tra.roi_max_span(cfg, (32, 42)) == (28.0, 36.0)


def bins_dividing_truly(start, extent, origin, win, limit, pool):
    """``detectron_tpu/ops/roi_align.py::_pool_bin_masks`` with its
    ``extent / pool`` kept a division under ``jax.jit``: XLA rewrites a
    division by a constant into a multiplication by its rounded reciprocal,
    so that ``(p + 1) * extent / pool`` lands above an integer it equals
    and ``ceil`` grows the bin by a cell (``extent * (1/7)``); op by op, as
    here, JAX divides as the reference CUDA kernel and the port do."""
    bin_size = extent / jax.lax.optimization_barrier(jnp.float32(pool))
    p = jnp.asarray(np.arange(pool, dtype=np.float32))
    lo = jnp.floor(p[None, :] * bin_size[:, None]).astype(jnp.int32)
    hi = jnp.ceil((p[None, :] + 1.0) * bin_size[:, None]).astype(jnp.int32)
    lo = jnp.clip(lo + start[:, None], 0, limit[:, None])
    hi = jnp.clip(hi + start[:, None], 0, limit[:, None])
    g = origin[:, None] + jnp.asarray(np.arange(win, dtype=np.int32))
    mask = (g[:, None, :] >= lo[:, :, None]) & (g[:, None, :] < hi[:, :, None])
    return mask, mask.any(axis=2)


def test_jitted_jax_pool_divides_by_the_reciprocal(monkeypatch):
    """The trap that the model tests below step around: jitted, the JAX
    function's bins differ from its own op-by-op result wherever a bin's
    end is an exact integer (extents that are multiples of 7 cells); the
    port equals the op-by-op result, and the jitted one once its division
    is kept."""
    feats, rois = levels(seed=9), pool_rois(seed=10)
    rois[:, 20:40] = np.array([0.0, 0.0, 7 * 8.0, 14 * 8.0]) + 8.0 * np.arange(20)[:, None]
    jitted = jax.jit(lambda f, r: jra.multilevel_roi_pool(f, r, STRIDES, 7))
    eager = jax_pool(feats, rois, 7)
    got = tra.multilevel_roi_pool([torch.tensor(f) for f in feats], torch.tensor(rois),
                                  STRIDES, 7).numpy()
    np.testing.assert_array_equal(got, eager)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(rois))
    assert not np.array_equal(np.asarray(jitted(*args)), eager)
    monkeypatch.setattr(jra, "_pool_bin_masks", bins_dividing_truly)
    jitted = jax.jit(lambda f, r: jra.multilevel_roi_pool(f, r, STRIDES, 7))
    np.testing.assert_array_equal(np.asarray(jitted(*args)), eager)


POOL = ["model.num_classes=4", "model.fpn_channels=32", "data.image_size=[128, 128]",
        "roi.pool_type=pool", "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
        "test.detections_per_image=10", "rpn.pre_nms_topk_train=128",
        "rpn.post_nms_topk_train=32", "roi.batch_per_image=32", "train.batch_size=2",
        "train.max_gt_boxes=8", "train.grad_clip_norm=1.0"]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_mask_rcnn_predict_with_roi_pool_matches_jax(monkeypatch):
    monkeypatch.setattr(jra, "_pool_bin_masks", bins_dividing_truly)
    overrides = ["model.name=mask_rcnn"] + POOL
    jdet = jax_build_detector(jax_get_config(None, overrides))
    variables = numpy_tree(jdet.init(jax.random.PRNGKey(0), (128, 128)))
    bias = np.array(variables["params"]["box_head"]["cls_score"]["bias"])
    bias[[1, 3]] = 3.0
    variables["params"]["box_head"]["cls_score"]["bias"] = bias
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(2, 128, 128, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    j_dets, j_masks = jax.jit(jdet.predict_fn)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tdet = build_detector(get_config(None, overrides), device="cpu")

    def no_align(*args, **kwargs):
        raise AssertionError("RoIAlign called under roi.pool_type=pool")

    monkeypatch.setattr(tra.RoIAlignFunction, "apply", no_align)
    dets, masks = tdet.predict_fn(from_jax_params(variables, tdet.module), batch)
    assert int(dets.valid.sum()) > 0 and masks.shape == (2, 10, 28, 28)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(j_dets.valid))
    np.testing.assert_array_equal(dets.classes.numpy(), np.asarray(j_dets.classes))
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(j_dets.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(masks.numpy(), np.asarray(j_masks), rtol=0, atol=1e-4)


def test_faster_rcnn_train_step_with_roi_pool_matches_jax(monkeypatch):
    monkeypatch.setattr(jra, "_pool_bin_masks", bins_dividing_truly)
    overrides = ["model.name=faster_rcnn"] + POOL
    jcfg, tcfg = jax_get_config(None, overrides), get_config(None, overrides)
    jdet = jax_build_detector(jcfg)
    variables = jdet.init(jax.random.PRNGKey(0), (128, 128))
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    jstate, tx, _ = jax_state.create_train_state(jcfg, variables)
    key0 = jax.random.PRNGKey(1)

    def step(state, jbatch):
        key = jax.random.fold_in(key0, state.step)
        (_, ld), grads = jax.value_and_grad(
            lambda q: jdet.loss_fn(q, jbatch, key), has_aux=True)(state.params)
        return jax_state.apply_gradients(state, grads, tx), ld

    jstate, want = jax.jit(step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tdet = build_detector(tcfg, device="cpu")
    before = from_jax_params(numpy_tree(variables), tdet.module)
    tst = tstate.create_train_state(tcfg, tdet, {k: v.clone() for k, v in before.items()})
    num_anchors = sum(a.shape[0] for a in tdet.module.anchors((128, 128), "cpu"))
    got = tstate.train_step(tst, batch, jax_draws(key0, 0, num_anchors, 32 + 8))
    assert set(want) == {"loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box"}
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=1e-4, err_msg=name)
    after, j_after = tst.params, from_jax_params(numpy_tree(jstate.params))
    worst = {}
    for name, value in after.items():
        upd_j = j_after[name] - before[name]
        if float(upd_j.abs().max()):
            worst[name] = float(torch.linalg.vector_norm((value - before[name]) - upd_j)
                                / torch.linalg.vector_norm(upd_j))
    assert any(n.startswith("box_head.fc1.") for n in worst) and len(worst) > 50
    name = max(worst, key=worst.get)
    assert worst[name] <= UPDATE_RTOL, (name, worst[name])
